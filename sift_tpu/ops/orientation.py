"""Orientation assignment (reference C8c).

Functional twin of calcOrientationHist + the peak-expansion loop
(src/sift.cpp:389-458, 519-541): 36-bin gradient-orientation
histogram in a radius cvRound(4.5*scl_octv) window, Gaussian-weighted
with sigma 1.5*scl_octv, circularly smoothed by (1,4,6,4,1)/16; every
local max >= 0.8*globalmax spawns an oriented keypoint with parabolic
sub-bin interpolation.

Restructured for XLA: the radius is data-dependent, so each
keypoint gathers a fixed max-radius patch (one vmapped dynamic_slice
from a pre-padded octave stack, which XLA emits as one parallel
gather) and masks samples outside its true radius/image interior.
Histogram accumulation is a one-hot contraction, not a scatter. Peak expansion emits a
fixed number of top peaks per keypoint (cfg.max_ori_peaks) instead of
an unbounded vector — peaks beyond that are vanishingly rare with the
0.8 ratio + strict-local-max rule.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.ops.mathutil import fast_atan2_deg, cv_round

_FLT_EPS = float(np.float32(1.1920929e-07))
_HI = jax.lax.Precision.HIGHEST


def _hist_bins(contrib: jnp.ndarray, bins: jnp.ndarray, n: int,
               impl: str = "onehot") -> jnp.ndarray:
    """Weighted histogram of (P,) contributions into n bins, scatter-
    free (a one-hot contraction has no write conflicts).

    "onehot": one (P, n) one-hot and a (1, P) @ (P, n) matmul — under
        vmap this materializes an (N, P, n) intermediate with the n=36
        bins as the minor axis.
    "onehot_t": the transposed (n, P) one-hot and an (n, P) @ (P,)
        matvec — the P~1700 patch samples are the minor axis. Same
        element count as "onehot".
    "factored": decompose bin = n2*hi + lo with n2 = ceil(sqrt(n));
        two (P, n2) one-hots and a (n2, P) @ (P, n2) matmul build the
        same histogram with ~n/(2*n2) times less intermediate traffic
        (36 -> 12 floats per sample for n=36). Same math, float sums
        reassociated.

    Every product runs at full float32 precision: on a GPU the default
    may be TF32, whose 10-bit mantissa would perturb the 0.8*max peak
    test against the reference.
    """
    if impl == "onehot_t":
        onehot_t = (jnp.arange(n)[:, None] == bins[None, :]
                    ).astype(jnp.float32)              # (n, P)
        return jnp.matmul(onehot_t, contrib, precision=_HI)   # (n,)
    if impl == "factored":
        n2 = int(np.ceil(np.sqrt(n)))
        hi = bins // n2
        lo = bins - hi * n2
        oh_hi = (hi[:, None] == jnp.arange(n2)[None, :]
                 ).astype(jnp.float32)
        oh_lo = (lo[:, None] == jnp.arange(n2)[None, :]
                 ).astype(jnp.float32)
        h2 = jnp.matmul((oh_hi * contrib[:, None]).T, oh_lo,
                        precision=_HI)                   # (n2, n2)
        return h2.reshape(n2 * n2)[:n]
    if impl != "onehot":
        raise ValueError(f"unknown hist impl {impl!r}")
    onehot = (bins[:, None] == jnp.arange(n)[None, :]
              ).astype(jnp.float32)
    return jnp.matmul(contrib[None, :], onehot, precision=_HI)[0]


def orientation_peaks(gauss: jnp.ndarray,
                      layer: jnp.ndarray, r: jnp.ndarray, c: jnp.ndarray,
                      scl_octv: jnp.ndarray, valid: jnp.ndarray,
                      cfg: SIFTConfig = DEFAULT_CONFIG,
                      row_bounds=None,
                      hist_impl: str = "onehot"
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compute up to max_ori_peaks orientations per refined keypoint.

    gauss: (S, H, W) Gaussian stack of one octave.
    layer/r/c/scl_octv/valid: (N,) refined keypoints (octave space).
    row_bounds: optional (lo, hi) — the array rows that correspond to
        the TRUE image (spatially-tiled execution passes the local
        offsets of the global image edges; rows outside behave like
        the reference's out-of-image samples, src/sift.cpp:411).
        Default (0, H): the array is the whole image.
    Returns (angles (N, K) degrees, peak_valid (N, K)).
    """
    n = cfg.ori_hist_bins
    k_peaks = cfg.max_ori_peaks
    rp = cfg.ori_patch_radius
    nl = cfg.n_octave_layers
    h, w = gauss.shape[1], gauss.shape[2]
    row_lo, row_hi = (0, h) if row_bounds is None else row_bounds
    pad = rp + 1
    # refined keypoints always sit on layers 1..nl (refine clamps,
    # sift.cpp:332) — padding the base/top layers would double the
    # materialized gather source for nothing
    padded = jnp.pad(gauss[1:1 + nl], ((0, 0), (pad, pad), (pad, pad)))

    # gather one fixed max-radius patch per keypoint; the center lands
    # at local index (rp+1, rp+1) == image (r0, c0)
    pn = 2 * rp + 3
    patches = jax.vmap(lambda l0, r0, c0: jax.lax.dynamic_slice(
        padded, (l0 - 1, r0, c0), (1, pn, pn))[0])(layer, r, c)

    # static offset grids for the max patch
    off = np.arange(-rp, rp + 1, dtype=np.int32)
    ii = jnp.asarray(off)[:, None]          # (2rp+1, 1) row offsets
    jj = jnp.asarray(off)[None, :]          # (1, 2rp+1) col offsets
    r2_grid = (ii * ii + jj * jj).astype(jnp.float32)

    def one(patch, r0, c0, scl0, valid0):
        dx = patch[1:-1, 2:] - patch[1:-1, :-2]
        dy = patch[:-2, 1:-1] - patch[2:, 1:-1]

        radius = cv_round(cfg.ori_radius_fctr * scl0)
        sigma = cfg.ori_sig_fctr * scl0
        expf_scale = -1.0 / (2.0 * sigma * sigma)

        yy = r0 + ii
        xx = c0 + jj
        m = ((jnp.abs(ii) <= radius) & (jnp.abs(jj) <= radius)
             & (yy > row_lo) & (yy < row_hi - 1)
             & (xx > 0) & (xx < w - 1))
        wgt = jnp.exp(r2_grid * expf_scale)
        mag = jnp.sqrt(dx * dx + dy * dy)
        ori = fast_atan2_deg(dy, dx)
        contrib = jnp.where(m, wgt * mag, 0.0)

        bins = cv_round((n / 360.0) * ori)
        bins = jnp.where(bins >= n, bins - n, bins)
        bins = jnp.where(bins < 0, bins + n, bins)
        hist = _hist_bins(contrib.reshape(-1), bins.reshape(-1), n,
                          hist_impl)

        # circular (1,4,6,4,1)/16 smoothing (src/sift.cpp:440-451)
        sm = (jnp.roll(hist, 2) + jnp.roll(hist, -2)) * (1.0 / 16.0) \
            + (jnp.roll(hist, 1) + jnp.roll(hist, -1)) * (4.0 / 16.0) \
            + hist * (6.0 / 16.0)

        maxval = jnp.max(sm)
        left = jnp.roll(sm, 1)
        right = jnp.roll(sm, -1)
        peak = (sm > left) & (sm > right) & (sm >= maxval * cfg.ori_peak_ratio)
        pv, pj = jax.lax.top_k(jnp.where(peak, sm, -1.0), k_peaks)
        hl = left[pj]
        hr = right[pj]
        bin_f = pj.astype(jnp.float32) + 0.5 * (hl - hr) / (
            hl - 2.0 * sm[pj] + hr)
        bin_f = jnp.where(bin_f < 0, bin_f + n,
                          jnp.where(bin_f >= n, bin_f - n, bin_f))
        angle = 360.0 - (360.0 / n) * bin_f
        angle = jnp.where(jnp.abs(angle - 360.0) < _FLT_EPS, 0.0, angle)
        ok = (pv > 0) & valid0
        return angle, ok

    return jax.vmap(one)(patches, r, c, scl_octv, valid)
