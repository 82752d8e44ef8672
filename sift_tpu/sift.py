"""SIFT detect + describe facade (replaces reference C9, SIFT_NCL).

Twin of SIFT_NCL (src/sift.cpp:59-91) restructured for XLA: the
whole pipeline is jittable with static shapes. Keypoints live in
fixed-capacity masked batches (per-octave candidate caps, global
max_keypoints), dynamic std::vector growth replaced by top_k
compaction.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.types import Keypoints
from sift_tpu.ops import pyramid as pyr
from sift_tpu.ops import extrema as ext
from sift_tpu.ops import refine as ref
from sift_tpu.ops import orientation as ori
from sift_tpu.ops import descriptor as desc_mod


def detect_octave(gauss: jnp.ndarray, dog: jnp.ndarray, octave: int,
                  cap: int, cfg: SIFTConfig = DEFAULT_CONFIG,
                  out_cap: int = 0) -> Keypoints:
    """Detect, refine and orient keypoints on one octave.

    `cap` bounds extremum candidates; the result is compacted down to
    `out_cap` slots (default: cap) ranked by (valid, response) —
    out_cap < cap halves descriptor/matcher work since measured valid
    counts run far below candidate caps (config.py:out_caps).

    Truncation detection: the mid-compaction below can drop valid
    refined candidates when more than out_cap survive refinement; in
    that case the final batch is NEAR-full (orientation rejections may
    invalidate a few of the kept slots), which `octave_saturation`'s
    near-full test flags.
    """
    out_cap = out_cap or cap
    layer0, r0, c0, valid0 = ext.top_candidates(dog, cap, cfg)
    return _octave_tail(gauss, dog, layer0, r0, c0, valid0,
                        octave, cfg, out_cap)


def _octave_tail(gauss, dog, layer0, r0, c0, valid0, octave: int,
                 cfg: SIFTConfig, out_cap: int,
                 row_bounds=None) -> Keypoints:
    """Refine + orient + compact, given the candidate scan's output.

    Split out of detect_octave so the batched path can run the
    candidate top-k batched (its saturation lax.cond must stay out of
    vmap) and vmap only this gather-heavy tail. row_bounds: local rows
    of the TRUE image for spatially-tiled execution (parallel/spatial)."""
    rf = ref.refine_candidates(dog, layer0, r0, c0, valid0, cfg,
                               row_bounds=row_bounds)
    cap = layer0.shape[0]

    # mid-compaction: refinement rejects ~70% of candidates (contrast/
    # edge tests), so orientation+descriptor work shrinks to out_cap
    # slots here rather than carrying the full candidate cap through
    if out_cap < cap:
        mscore = jnp.where(rf.valid, jnp.abs(rf.contr) + 10.0, -1.0)
        _, midx = jax.lax.top_k(mscore, out_cap)
        rf = ref.Refined(*(a[midx] for a in rf))

    nl = cfg.n_octave_layers
    lay_f = rf.layer.astype(jnp.float32)
    scl_octv = cfg.sigma * jnp.exp2((lay_f + rf.xi) / nl)
    size = scl_octv * (1 << octave) * 2.0           # src/sift.cpp:384
    angles, ok = ori.orientation_peaks(
        gauss, rf.layer, rf.r, rf.c, scl_octv, rf.valid, cfg,
        row_bounds=row_bounds, hist_impl=cfg.ori_hist_impl)

    k = cfg.max_ori_peaks
    scale = float(1 << octave)

    def tile(a):
        return jnp.repeat(a, k, axis=0)

    kp = Keypoints(
        x=tile((rf.c.astype(jnp.float32) + rf.xc) * scale),
        y=tile((rf.r.astype(jnp.float32) + rf.xr) * scale),
        size=tile(size),
        angle=angles.reshape(-1),
        response=tile(jnp.abs(rf.contr)),
        octave=jnp.full((rf.layer.shape[0] * k,), octave, jnp.int32),
        layer=tile(rf.layer),
        r=tile(rf.r),
        c=tile(rf.c),
        valid=ok.reshape(-1),
    )
    # compact (slots*k) -> out_cap slots (valid first, then response)
    score = jnp.where(kp.valid, kp.response + 10.0, -1.0)
    _, idx = jax.lax.top_k(score, out_cap)
    return kp.gather(idx)


def _octave_usable(shape, cfg: SIFTConfig) -> bool:
    """An octave participates only if the refinement/NMS windows fit
    (the reference hardcodes 5 octaves and would read out of bounds on
    tiny images; we emit empty batches instead, keeping output
    capacity static)."""
    return min(shape) >= max(2 * cfg.img_border + 3, 8)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect(img: jnp.ndarray, cfg: SIFTConfig = DEFAULT_CONFIG
           ) -> Tuple[Keypoints, List[jnp.ndarray]]:
    """Full detection: pyramid + extrema + refine + orientation.

    Returns (keypoints over all octaves, gaussian octave stacks).
    """
    octs = pyr.build_gaussian_pyramid(img, cfg)
    dogs = pyr.build_dog_pyramid(octs)
    parts = []
    for o in range(cfg.n_octaves):
        if _octave_usable(octs[o].shape[1:], cfg):
            parts.append(detect_octave(octs[o], dogs[o], o,
                                       cfg.detect_caps[o], cfg,
                                       cfg.out_caps[o]))
        else:
            parts.append(Keypoints.zeros(cfg.out_caps[o]))
    return Keypoints.concatenate(tuple(parts)), octs


@functools.partial(jax.jit, static_argnames=("cfg",))
def candidate_saturation(octs: List[jnp.ndarray],
                         cfg: SIFTConfig = DEFAULT_CONFIG
                         ) -> jnp.ndarray:
    """(n_octaves,) bool: octave o's NMS survivors exceed its
    detect_caps[o] candidate budget.

    Candidate-level truncation happens BEFORE refinement, where
    refinement typically rejects ~70-80% — so a saturated candidate
    cap loses keypoints invisibly to octave_saturation's output-batch
    check (that is exactly how the rotate1080 recall failure hid:
    2481 survivors > 2048 cap with the output batch only 190/1024
    full). Counts the exact dense mask, so the flag is authoritative;
    callers (cli/eval) surface it and should raise detect_caps.
    """
    dogs = pyr.build_dog_pyramid(octs)
    flags = []
    for o in range(cfg.n_octaves):
        if _octave_usable(octs[o].shape[1:], cfg):
            m = ext.extrema_mask(dogs[o], cfg)
            flags.append(jnp.sum(m) > cfg.detect_caps[o])
        else:
            flags.append(jnp.asarray(False))
    return jnp.stack(flags)


def octave_saturation(kp: Keypoints, cfg: SIFTConfig = DEFAULT_CONFIG
                      ) -> jnp.ndarray:
    """(n_octaves,) bool: octave o's output batch is (near-)full.

    A near-full batch means the out_caps[o] compactions MAY have
    dropped valid keypoints (ranked by response, weakest first) — the
    fixed-capacity analogue of the reference's unbounded std::vector emit
    (src/sift.cpp:538). NEAR-full rather than exactly full: the
    mid-compaction (detect_octave) truncates BEFORE orientation, whose
    strict-local-max rule can then invalidate a few kept slots — an
    exactly-full test would miss that loss. Callers should bump
    out_caps when this fires; cli/eval surface it via
    utils.logger.COUNTERS."""
    flags = []
    start = 0
    for o in range(cfg.n_octaves):
        n = cfg.out_caps[o]
        slack = max(n // 16, 4)
        flags.append(jnp.sum(kp.valid[start:start + n]) >= n - slack)
        start += n
    return jnp.stack(flags)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_and_compute(img: jnp.ndarray, cfg: SIFTConfig = DEFAULT_CONFIG
                       ) -> Tuple[Keypoints, jnp.ndarray]:
    """Twin of SIFT_NCL (src/sift.cpp:59-91): keypoints + descriptors.

    Descriptors are computed per octave (keypoint batches stay aligned
    with their octave's image stack), then concatenated; invalid slots
    hold zero descriptors.
    """
    octs = pyr.build_gaussian_pyramid(img, cfg)
    dogs = pyr.build_dog_pyramid(octs)
    kp_parts = []
    d_parts = []
    for o in range(cfg.n_octaves):
        if _octave_usable(octs[o].shape[1:], cfg):
            kp = detect_octave(octs[o], dogs[o], o,
                               cfg.detect_caps[o], cfg,
                               cfg.out_caps[o])
            d = desc_mod.descriptors_octave(octs[o], kp, cfg)
        else:
            kp = Keypoints.zeros(cfg.out_caps[o])
            d = jnp.zeros((cfg.out_caps[o], cfg.descr_size),
                          jnp.float32)
        kp_parts.append(kp)
        d_parts.append(d)
    return (Keypoints.concatenate(tuple(kp_parts)),
            jnp.concatenate(d_parts, axis=0))


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_and_compute_batch(imgs: jnp.ndarray,
                             cfg: SIFTConfig = DEFAULT_CONFIG
                             ) -> Tuple[Keypoints, jnp.ndarray]:
    """Single-device throughput mode: B frames in one program.

    (B, H, W) -> (Keypoints with (B, N) fields, (B, N, 128)
    descriptors); row b equals detect_and_compute(imgs[b]) exactly
    (parity-tested). Latency-mode dispatch runs the per-octave
    programs one frame at a time and underfills the device on small
    octaves; here the batch rides one grid/conv axis through pyramid
    and extrema scan, and the gather-heavy tail is vmapped. Use
    jax.tree.map(lambda a: a[b], kp) for a per-frame view.
    """
    octs = pyr.build_gaussian_pyramid_batch(imgs, cfg)
    dogs = pyr.build_dog_pyramid_batch(octs)
    kp_parts = []
    d_parts = []
    for o in range(cfg.n_octaves):
        out_cap = cfg.out_caps[o]
        if _octave_usable(octs[o].shape[2:], cfg):
            cands = ext.top_candidates_batch(dogs[o],
                                             cfg.detect_caps[o], cfg)

            def tail(gauss, dog, layer0, r0, c0, valid0,
                     _o=o, _cap=out_cap):
                kp = _octave_tail(gauss, dog, layer0, r0, c0, valid0,
                                  _o, cfg, _cap)
                return kp, desc_mod.descriptors_octave(gauss, kp, cfg)

            kp, d = jax.vmap(tail)(octs[o], dogs[o], *cands)
        else:
            nb = imgs.shape[0]
            kp = jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (nb,) + a.shape),
                Keypoints.zeros(out_cap))
            d = jnp.zeros((nb, out_cap, cfg.descr_size), jnp.float32)
        kp_parts.append(kp)
        d_parts.append(d)
    kp_all = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1),
                          *kp_parts)
    return kp_all, jnp.concatenate(d_parts, axis=1)
