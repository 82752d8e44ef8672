"""128-d SIFT descriptor extraction (reference C10).

Functional twin of calcSIFTDescriptor/calDescriptor
(src/sift.cpp:579-753): rotated 4x4 spatial grid x 8 orientation bins
over a radius cvRound(3*scl*sqrt(2)*2.5) window, trilinear histogram
scatter, then the reference's exact normalization chain — L2-clip at
0.2*||v||, x512, uchar saturate, re-multiply, L1-normalize, sqrt
(the RootSIFT-style tail at src/sift.cpp:711-721 that makes NORM_L1
matching with ratio 0.86 work).

Restructured for XLA: the reference's per-sample scatter into a
(d+2)x(d+2)x(n+2) histogram becomes per-axis soft one-hot weight
matrices contracted as a matrix product (tensor cores in bf16):

    hist[(row,col), ori] = sum_p RC[p, (row,col)] * OM[p, ori]

where RC is the outer product of the row/col trilinear weights and OM
carries the orientation weights times gradient magnitude. Keypoints
gather fixed max-radius patches from a pre-padded octave stack (one
vmapped dynamic_slice; no data-dependent shapes) and mask the samples
their true radius excludes. Batched over keypoints with vmap, chunked
with lax.map to bound the RC intermediate.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.types import Keypoints
from sift_tpu.ops.mathutil import fast_atan2_deg, cv_round

_FLT_EPS = float(np.float32(1.1920929e-07))


def descriptors_octave(gauss: jnp.ndarray, kp: Keypoints,
                       cfg: SIFTConfig = DEFAULT_CONFIG,
                       chunk: int = 64, row_bounds=None) -> jnp.ndarray:
    """Descriptors for one octave's keypoint batch: (N,) -> (N, 128).

    kp fields are octave-space (r, c integer center; layer; size);
    invalid slots yield zero rows. row_bounds: optional (lo, hi) local
    rows of the TRUE image for spatially-tiled execution (samples
    outside behave like out-of-image, src/sift.cpp:616); default the
    whole array.
    """
    d = cfg.descr_width
    n = cfg.descr_hist_bins
    rd = cfg.descr_patch_radius
    s_img, h, w = gauss.shape
    row_lo, row_hi = (0, h) if row_bounds is None else row_bounds
    pad = rd + 1
    # keypoints always sit on layers 1..nl (refine clamps,
    # sift.cpp:332); don't materialize padded copies of the base/top
    # layers that are never gathered (invalid slots may carry layer 0
    # — dynamic_slice clamps and the valid mask zeroes their rows)
    nl_g = cfg.n_octave_layers
    padded = jnp.pad(gauss[1:1 + nl_g],
                     ((0, 0), (pad, pad), (pad, pad)))
    diag = int(math.sqrt(float(w) * w + float(h) * h))  # src/sift.cpp:590

    off = np.arange(-rd, rd + 1, dtype=np.float32)
    jj = jnp.asarray(off)[None, :]
    ii = jnp.asarray(off)[:, None]
    jj_i = jnp.asarray(off.astype(np.int32))[None, :]
    ii_i = jnp.asarray(off.astype(np.int32))[:, None]

    octave = kp.octave[0]  # uniform within an octave batch
    inv_scale = jnp.exp2(-octave.astype(jnp.float32))

    def one(patch, r0, c0, size0, angle0, valid0):
        scl = size0 * inv_scale * 0.5          # src/sift.cpp:745-751
        ori = 360.0 - angle0                   # src/sift.cpp:748-750
        ori = jnp.where(jnp.abs(ori - 360.0) < _FLT_EPS, 0.0, ori)
        hist_width = cfg.descr_scl_fctr * scl
        radius = cv_round(hist_width * math.sqrt(2.0) * (d + 1) * 0.5)
        radius = jnp.minimum(radius, diag)
        cos_t = jnp.cos(ori * (math.pi / 180.0)) / hist_width
        sin_t = jnp.sin(ori * (math.pi / 180.0)) / hist_width

        dx = patch[1:-1, 2:] - patch[1:-1, :-2]
        dy = patch[:-2, 1:-1] - patch[2:, 1:-1]

        c_rot = jj * cos_t - ii * sin_t
        r_rot = jj * sin_t + ii * cos_t
        rbin = r_rot + (d / 2 - 0.5)
        cbin = c_rot + (d / 2 - 0.5)
        rr = r0 + ii_i
        cc = c0 + jj_i
        m = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
             & (rr > row_lo) & (rr < row_hi - 1)
             & (cc > 0) & (cc < w - 1)
             & (jnp.abs(ii_i) <= radius) & (jnp.abs(jj_i) <= radius))

        wgt = jnp.exp((c_rot * c_rot + r_rot * r_rot)
                      * (-1.0 / (d * d * 0.5)))
        mag_g = jnp.sqrt(dx * dx + dy * dy)
        theta = fast_atan2_deg(dy, dx)
        obin = (theta - ori) * (n / 360.0)
        mag = jnp.where(m, mag_g * wgt, 0.0)

        rbin_f = rbin.reshape(-1)
        cbin_f = cbin.reshape(-1)
        obin_f = obin.reshape(-1)
        mag_f = mag.reshape(-1)

        r0i = jnp.floor(rbin_f)
        c0i = jnp.floor(cbin_f)
        o0i = jnp.floor(obin_f)
        fr = rbin_f - r0i
        fc = cbin_f - c0i
        fo = obin_f - o0i
        r0i = r0i.astype(jnp.int32)
        c0i = c0i.astype(jnp.int32)
        o0i = o0i.astype(jnp.int32)
        o0i = jnp.where(o0i < 0, o0i + n, o0i)
        o0i = jnp.where(o0i >= n, o0i - n, o0i)

        rows = jnp.arange(d + 2)
        obins = jnp.arange(n + 2)
        if cfg.descr_layout == "kp":
            # transposed layout: the P~6900 samples are the minor
            # axis and the 6/10/36-wide bin axes the major one
            rw = ((rows[:, None] == (r0i + 1)[None, :]) * (1.0 - fr)[None, :]
                  + (rows[:, None] == (r0i + 2)[None, :]) * fr[None, :])
            cw = ((rows[:, None] == (c0i + 1)[None, :]) * (1.0 - fc)[None, :]
                  + (rows[:, None] == (c0i + 2)[None, :]) * fc[None, :])
            ow = ((obins[:, None] == o0i[None, :]) * (1.0 - fo)[None, :]
                  + (obins[:, None] == (o0i + 1)[None, :]) * fo[None, :])
            ow = ow * mag_f[None, :]
            rc = (rw[:, None, :] * cw[None, :, :]
                  ).reshape((d + 2) * (d + 2), -1)
            if cfg.descr_rc_bf16:
                hist = jnp.einsum("kp,op->ko", rc.astype(jnp.bfloat16),
                                  ow.astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32)
            else:
                hist = jnp.einsum("kp,op->ko", rc, ow,
                                  precision=jax.lax.Precision.HIGHEST)
        else:
            # trilinear soft one-hots: (P, d+2), (P, d+2), (P, n+2)
            rw = ((rows[None, :] == (r0i + 1)[:, None]) * (1.0 - fr)[:, None]
                  + (rows[None, :] == (r0i + 2)[:, None]) * fr[:, None])
            cw = ((rows[None, :] == (c0i + 1)[:, None]) * (1.0 - fc)[:, None]
                  + (rows[None, :] == (c0i + 2)[:, None]) * fc[:, None])
            ow = ((obins[None, :] == o0i[:, None]) * (1.0 - fo)[:, None]
                  + (obins[None, :] == (o0i + 1)[:, None]) * fo[:, None])
            ow = ow * mag_f[:, None]

            rc = (rw[:, :, None] * cw[:, None, :]
                  ).reshape(-1, (d + 2) * (d + 2))
            if cfg.descr_rc_bf16:
                # bf16 one-hot + magnitudes with f32 accumulation:
                # halves the memory traffic of the pipeline's largest
                # intermediate and runs on tensor cores; ~1e-2 L1
                # deviation, validated by the recall gate
                hist = jnp.einsum("pk,po->ko", rc.astype(jnp.bfloat16),
                                  ow.astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32)
            else:
                # bit-exact parity mode: full float32 products (no
                # TF32 or bf16 passes)
                hist = jnp.einsum("pk,po->ko", rc, ow,
                                  precision=jax.lax.Precision.HIGHEST)
        hist = hist.reshape(d + 2, d + 2, n + 2)
        # circular orientation fold (src/sift.cpp:676-684)
        hist = hist.at[:, :, 0].add(hist[:, :, n])
        hist = hist.at[:, :, 1].add(hist[:, :, n + 1])
        dst = hist[1:1 + d, 1:1 + d, :n].reshape(d * d * n)

        # normalization chain (src/sift.cpp:689-721)
        nrm2 = jnp.sum(dst * dst)
        thr = jnp.sqrt(nrm2) * cfg.descr_mag_thr
        dst = jnp.minimum(dst, thr)
        nrm2 = jnp.sum(dst * dst)
        nrm2 = cfg.int_descr_fctr / jnp.maximum(jnp.sqrt(nrm2), _FLT_EPS)
        q = jnp.clip(jnp.rint(dst * nrm2), 0.0, 255.0)
        q = q * nrm2
        nrm1 = 1.0 / jnp.maximum(jnp.sum(q), _FLT_EPS)
        out = jnp.sqrt(q * nrm1)
        return jnp.where(valid0, out, jnp.zeros_like(out))

    cap = kp.capacity
    ch = min(chunk, cap)
    n_chunks = (cap + ch - 1) // ch
    assert cap % ch == 0, (cap, ch)

    pn = 2 * rd + 3

    # the gather runs PER CHUNK inside the lax.map body so the patch
    # intermediate stays bounded to chunk patches
    def run_chunk(args):
        layer_c, r_c, rest = args[0], args[1], args[2:]
        patch_c = jax.vmap(lambda l0, r0, c0: jax.lax.dynamic_slice(
            padded, (l0 - 1, r0, c0), (1, pn, pn))[0])(
                layer_c, r_c, rest[0])
        return jax.vmap(one)(patch_c, r_c, *rest)

    common = (kp.r.reshape(n_chunks, ch),
              kp.c.reshape(n_chunks, ch),
              kp.size.reshape(n_chunks, ch),
              kp.angle.reshape(n_chunks, ch),
              kp.valid.reshape(n_chunks, ch))
    out = jax.lax.map(
        run_chunk,
        (kp.layer.reshape(n_chunks, ch),) + common)
    return out.reshape(cap, d * d * n)
