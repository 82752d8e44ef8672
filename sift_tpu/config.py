"""SIFT parameter block and pipeline sizing configuration.

Mirrors the reference's file-static parameter block (reference:
src/sift.cpp:3-47) as an immutable dataclass, plus the static-shape
sizing knobs (candidate caps, max keypoints) that a jitted pipeline
needs because XLA requires static shapes where the reference grows
std::vectors dynamically.

Reference quirks we deliberately reproduce (they affect match parity):
  * n_octave_layers = 2 (non-standard; src/sift.cpp:4)
  * no initial 2x upsampling (createInitialImage ignores doubleSize;
    src/sift.cpp:219-227)
  * extrema threshold is the literal 8 on the 0..255 scale, not the
    computed cvFloor(...) = 2 (src/sift.cpp:551,564)
  * Gaussian kernels truncated at radius floor(3*sigma) and NOT
    renormalized (src/sift.cpp:95-108)
  * blur treats the last row/col as out-of-bounds zeros
    (getSubMatrix off-by-one, src/sift.cpp:116)
  * descriptors end sqrt(L1-normalized) ("RootSIFT tail",
    src/sift.cpp:711-721), which is why matching uses L1 distance
    with ratio 0.86 (src/main.cpp:25,38)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    # --- algorithm constants (reference src/sift.cpp:3-47) ---
    n_octaves: int = 5                   # literal 5 at call sites (sift.cpp:67-68,78)
    n_octave_layers: int = 2             # sift.cpp:4
    sigma: float = 1.6                   # sift.cpp:6
    contrast_threshold: float = 0.04     # sift.cpp:8
    edge_threshold: float = 10.0         # sift.cpp:9
    init_sigma_assumed: float = 0.2      # sqrt(Sigma^2 + 0.2^2) at sift.cpp:237
    descr_width: int = 4                 # SIFT_DESCR_WIDTH, sift.cpp:12
    descr_hist_bins: int = 8             # SIFT_DESCR_HIST_BINS, sift.cpp:15
    img_border: int = 5                  # SIFT_IMG_BORDER, sift.cpp:21
    max_interp_steps: int = 5            # SIFT_MAX_INTERP_STEPS, sift.cpp:24
    ori_hist_bins: int = 36              # SIFT_ORI_HIST_BINS, sift.cpp:27
    ori_sig_fctr: float = 1.5            # SIFT_ORI_SIG_FCTR, sift.cpp:30
    ori_radius_fctr: float = 4.5         # SIFT_ORI_RADIUS = 3*1.5, sift.cpp:33
    ori_peak_ratio: float = 0.8          # SIFT_ORI_PEAK_RATIO, sift.cpp:36
    descr_scl_fctr: float = 3.0          # SIFT_DESCR_SCL_FCTR, sift.cpp:39
    descr_mag_thr: float = 0.2           # SIFT_DESCR_MAG_THR, sift.cpp:42
    int_descr_fctr: float = 512.0        # SIFT_INT_DESCR_FCTR, sift.cpp:45
    nms_threshold: float = 8.0           # literal at sift.cpp:564 (NOT the computed 2)

    # --- static-shape sizing (no reference counterpart) ---
    # XLA needs static shapes where the reference grows std::vectors,
    # so every stage carries a fixed capacity sized for 1080p.
    # Max extremum candidates surfaced per octave (before refinement).
    # Rotated 1080p frames are extrema-dense along the rotation
    # boundary (~2500 octave-0 NMS survivors), so octave 0 carries
    # 4096. Truncation is |response|-ranked;
    # sift.candidate_saturation flags a full cap.
    detect_caps: Tuple[int, ...] = (4096, 2048, 512, 256, 128)
    # Final per-octave keypoint/descriptor capacity after refinement +
    # orientation expansion: ~1.5-2x headroom over the valid counts a
    # natural 1080p frame gives, and less than half the descriptor and
    # matcher work of using detect_caps as output caps.
    # octave_saturation flags any octave that fills its cap.
    out_caps: Tuple[int, ...] = (1024, 256, 128, 64, 64)
    # Max orientation peaks expanded per refined keypoint.
    max_ori_peaks: int = 4
    # Orientation histogram formulation: "onehot" materializes one
    # (P, 36) one-hot per keypoint; "onehot_t" the transposed (36, P)
    # one-hot; "factored" two (P, 6) one-hots (~3x less intermediate
    # traffic, same math reassociated). Parity tested in
    # tests/test_ori_cap.py. Not yet compared on the GPU (ROADMAP).
    ori_hist_impl: str = "onehot_t"
    # Final global keypoint budget after cross-octave compaction.
    max_keypoints: int = 4096
    # Matcher ratio-test threshold (reference src/main.cpp:38).
    match_ratio: float = 0.86
    # Materialize the descriptor trilinear one-hot (the pipeline's
    # largest intermediate, ~1 GB/frame at f32) in bfloat16: halves
    # its memory traffic and runs bf16 tensor-core products with f32
    # accumulation. Descriptor deviation stays ~1e-2 L1 (values are
    # 0..1 weights); the recall gate (eval.py) validates match
    # decisions end to end. False = bit-exact f32 mode (full float32
    # products; used by parity tests).
    descr_rc_bf16: bool = True
    # Descriptor one-hot layout: "pk" puts the trilinear bin axes
    # (6/10/36 wide) last; "kp" transposes so the ~6900 patch samples
    # are the minor axis. Same math. Not yet compared on the GPU.
    descr_layout: str = "pk"
    # Per-device execution mode for the multi-frame pipeline
    # (parallel/frames.py): "batch" runs detect_and_compute_batch on
    # the device's local frames in one grid-batched program; "scan"
    # runs the single-frame latency graph per local frame under
    # lax.map (one program, frames serialized on-device). Not yet
    # compared on the GPU.
    frames_per_chip_mode: str = "scan"

    def __post_init__(self):
        # variant literals are matched by string in the ops; a typo
        # would silently fall back to the default implementation and
        # make an A/B time the same arm twice — fail loudly instead
        if self.ori_hist_impl not in ("onehot", "onehot_t", "factored"):
            raise ValueError(
                f"ori_hist_impl={self.ori_hist_impl!r}: expected "
                "'onehot', 'onehot_t' or 'factored'")
        if self.descr_layout not in ("pk", "kp"):
            raise ValueError(
                f"descr_layout={self.descr_layout!r}: expected "
                "'pk' or 'kp'")
        if self.frames_per_chip_mode not in ("batch", "scan"):
            raise ValueError(
                f"frames_per_chip_mode={self.frames_per_chip_mode!r}: "
                "expected 'batch' or 'scan'")

    @property
    def n_scales(self) -> int:
        # nScales = nOctaveLayers + 3 (sift.cpp:5)
        return self.n_octave_layers + 3

    @property
    def n_dog(self) -> int:
        return self.n_scales - 1

    @property
    def descr_size(self) -> int:
        return self.descr_width * self.descr_width * self.descr_hist_bins

    @property
    def init_blur_sigma(self) -> float:
        # createInitialImage sigma = sqrt(Sigma^2 + 0.2^2) (sift.cpp:237)
        return math.sqrt(self.sigma * self.sigma
                         + self.init_sigma_assumed * self.init_sigma_assumed)

    def scale_sigmas(self) -> Tuple[float, ...]:
        """Per-scale blur sigmas applied to the octave *base* image.

        sig[i] = sqrt((k^i * sigma)^2 - sigma^2), k = 2^(1/nOctaveLayers)
        (reference sift.cpp:240-245). Unlike OpenCV's incremental
        layer-to-layer blur, every non-base layer is blurred directly
        from the octave base (sift.cpp:257-258) — which makes all layers
        of an octave independent and lets us batch them into one conv.
        """
        k = 2.0 ** (1.0 / self.n_octave_layers)
        sigs = [self.sigma]
        for i in range(1, self.n_scales):
            total = (k ** i) * self.sigma
            sigs.append(math.sqrt(total * total - self.sigma * self.sigma))
        return tuple(sigs)

    @property
    def max_scl_octv(self) -> float:
        """Upper bound on scl_octv = sigma * 2^((layer+xi)/nOctaveLayers).

        After refinement, layer <= nOctaveLayers and |xi| <= 0.5
        (sift.cpp:332,344), so the max exponent is
        (nOctaveLayers + 0.5)/nOctaveLayers.
        """
        return self.sigma * 2.0 ** (
            (self.n_octave_layers + 0.5) / self.n_octave_layers)

    @property
    def ori_patch_radius(self) -> int:
        """Static patch radius covering the largest orientation window.

        Reference radius = cvRound(SIFT_ORI_RADIUS * scl_octv)
        (sift.cpp:521); we gather a fixed max-size patch and mask.
        """
        return int(math.ceil(self.ori_radius_fctr * self.max_scl_octv))

    @property
    def descr_patch_radius(self) -> int:
        """Static patch radius covering the largest descriptor window.

        Reference radius = cvRound(hist_width * sqrt(2) * (d+1) * 0.5),
        hist_width = 3 * scl (sift.cpp:587-588).
        """
        hw = self.descr_scl_fctr * self.max_scl_octv
        return int(math.ceil(hw * math.sqrt(2.0) * (self.descr_width + 1) * 0.5))


DEFAULT_CONFIG = SIFTConfig()
