"""Batched subpixel refinement + contrast/edge filtering (reference C8b).

Functional twin of adjustLocalExtrema (src/sift.cpp:287-388): up to 5
Newton steps on the 3x3x3 DoG cube, quadratic-fit contrast test, and
Hessian edge-response test. The reference refines one keypoint at a
time with an LU solve; we vmap a closed-form Cramer 3x3 solve over a
fixed-capacity candidate batch with masked state — no data-dependent
control flow, everything unrolled for XLA.

Layout: instead of gathering a 3x3x3 cube per candidate per step
(27-element gathers per candidate), the ten derivative fields the
Newton step needs (gradient, Hessian entries, center value) are
computed DENSELY over the octave once — pure fused shift-adds — and
each step gathers one 10-float row per candidate.

Matching OpenCV's Matx::solve(DECOMP_LU) behavior on singular Hessians
(solution := 0, which the reference then treats as converged), we map
|det| ~ 0 to a zero update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.ops.mathutil import cv_round

_IMG_SCALE = 1.0 / 255.0       # src/sift.cpp:291
_DERIV_SCALE = _IMG_SCALE * 0.5
_SECOND_DERIV_SCALE = _IMG_SCALE
_CROSS_DERIV_SCALE = _IMG_SCALE * 0.25
_DIVERGE_LIMIT = float(2 ** 31) / 3.0   # src/sift.cpp:335-338


class Refined(NamedTuple):
    """Per-candidate refinement result (octave-space)."""
    layer: jnp.ndarray
    r: jnp.ndarray
    c: jnp.ndarray
    xi: jnp.ndarray
    xr: jnp.ndarray
    xc: jnp.ndarray
    contr: jnp.ndarray
    valid: jnp.ndarray


def _solve3x3(h00, h01, h02, h11, h12, h22, b0, b1, b2):
    """Cramer solve of the symmetric 3x3 system H x = b.

    On |det| ~ 0 returns zeros, mirroring OpenCV's singular-LU
    behavior the reference inherits.
    """
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    det = h00 * c00 + h01 * c01 + h02 * c02
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    safe = jnp.abs(det) > 1e-30
    inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return x0, x1, x2


def derivative_fields(dog: jnp.ndarray, n_layers: int | None = None):
    """Dense Newton-step inputs over the octave's SCANNED layers: a
    10-tuple of flat (L*H*W,) arrays [d0 d1 d2 dxx dxy dxs dyy dys dss
    center] covering DoG layers 1..L (L = n_layers, default D-2),
    scaled per src/sift.cpp:291-295. Newton keeps lay in [1, L]
    (sift.cpp:332), so fields on layers 0 and L+1 would never be
    gathered — computing them doubled the dense-field HBM traffic for
    nothing (the D=4 stack needs only 2 field layers). The stencil
    still READS layers 0 and L+1 of the DoG for the layer-axis
    derivatives. Values at array borders use zero padding but are
    never read: candidates stay >= img_border from every edge.

    Layout is deliberately a TUPLE of flat arrays: stacking on a
    trailing (..., 10) axis lane-pads 10 -> 128 (a measured 13x HBM
    traffic blowup), while a (10, DHW) stack forces per-candidate
    gathers along the LANE axis (measured +3 ms per octave at 1080p).
    Ten 1-D row gathers cost ~0.2 ms total instead.

    Gather index for (lay, r, c): ((lay - 1) * H + r) * W + c.
    """
    d, h, w = dog.shape
    nl = d - 2 if n_layers is None else n_layers
    p = jnp.pad(dog, 1)

    def val(dl, dr, dc):
        # layer window [1+dl, 1+dl+nl) of the original dog stack
        return jax.lax.dynamic_slice(p, (2 + dl, 1 + dr, 1 + dc),
                                     (nl, h, w))

    v2 = dog[1:1 + nl] * 2.0
    d0 = (val(0, 0, 1) - val(0, 0, -1)) * _DERIV_SCALE
    d1 = (val(0, 1, 0) - val(0, -1, 0)) * _DERIV_SCALE
    d2 = (val(1, 0, 0) - val(-1, 0, 0)) * _DERIV_SCALE
    dxx = (val(0, 0, 1) + val(0, 0, -1) - v2) * _SECOND_DERIV_SCALE
    dyy = (val(0, 1, 0) + val(0, -1, 0) - v2) * _SECOND_DERIV_SCALE
    dss = (val(1, 0, 0) + val(-1, 0, 0) - v2) * _SECOND_DERIV_SCALE
    dxy = (val(0, 1, 1) - val(0, 1, -1) - val(0, -1, 1)
           + val(0, -1, -1)) * _CROSS_DERIV_SCALE
    dxs = (val(1, 0, 1) - val(1, 0, -1) - val(-1, 0, 1)
           + val(-1, 0, -1)) * _CROSS_DERIV_SCALE
    dys = (val(1, 1, 0) - val(1, -1, 0) - val(-1, 1, 0)
           + val(-1, -1, 0)) * _CROSS_DERIV_SCALE
    return tuple(x.reshape(nl * h * w)
                 for x in (d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss,
                           dog[1:1 + nl]))


def refine_candidates(dog: jnp.ndarray,
                      layer: jnp.ndarray, r: jnp.ndarray, c: jnp.ndarray,
                      valid: jnp.ndarray,
                      cfg: SIFTConfig = DEFAULT_CONFIG,
                      row_bounds=None) -> Refined:
    """Refine a batch of candidates on one octave's (D, H, W) DoG stack.

    row_bounds: optional (lo, hi) local rows of the TRUE image —
    spatially-tiled execution bounds Newton moves against the global
    border (src/sift.cpp:341-346 semantics), not the tile edge.
    """
    h, w = dog.shape[1], dog.shape[2]
    row_lo, row_hi = (0, h) if row_bounds is None else row_bounds
    nl = cfg.n_octave_layers
    border = cfg.img_border
    fields = derivative_fields(dog, nl)

    # Ten separate per-field gathers per fetch. The alternative —
    # concatenating the fields into one (10*DHW,) buffer and issuing
    # ONE gather of 10*N indices — adds a full extra write pass of the
    # fields; it has not been compared on the GPU.
    def fetch(lay, rr, cc):
        """(N,) coords -> 10-tuple of per-candidate (N,) gathers.
        lay is always in [1, nl]; fields cover exactly those layers."""
        idx = ((lay - 1) * h + rr) * w + cc
        return tuple(f[idx] for f in fields)

    lay, rr, cc = layer, r, c
    n = layer.shape[0]
    xi = jnp.zeros((n,), jnp.float32)
    xr = jnp.zeros((n,), jnp.float32)
    xc = jnp.zeros((n,), jnp.float32)
    converged = jnp.zeros((n,), bool)
    alive = valid

    # unrolled SIFT_MAX_INTERP_STEPS Newton steps (src/sift.cpp:300-348)
    for _ in range(cfg.max_interp_steps):
        active = alive & ~converged
        (d0, d1, d2, dxx, dxy, dxs, dyy, dys, dss,
         _center) = fetch(lay, rr, cc)
        x0, x1, x2 = _solve3x3(dxx, dxy, dxs, dyy, dys, dss, d0, d1, d2)
        nxi, nxr, nxc = -x2, -x1, -x0
        finite = (jnp.isfinite(nxi) & jnp.isfinite(nxr)
                  & jnp.isfinite(nxc))
        conv_now = ((jnp.abs(nxi) < 0.5) & (jnp.abs(nxr) < 0.5)
                    & (jnp.abs(nxc) < 0.5) & finite)
        diverged = ~finite | (jnp.abs(nxi) > _DIVERGE_LIMIT) | \
            (jnp.abs(nxr) > _DIVERGE_LIMIT) | (jnp.abs(nxc) > _DIVERGE_LIMIT)
        # update stored offsets whenever this step ran
        xi = jnp.where(active, nxi, xi)
        xr = jnp.where(active, nxr, xr)
        xc = jnp.where(active, nxc, xc)
        move = active & ~conv_now & ~diverged
        nlay = lay + jnp.where(move, cv_round(nxi), 0)
        nr = rr + jnp.where(move, cv_round(nxr), 0)
        nc = cc + jnp.where(move, cv_round(nxc), 0)
        oob = ((nlay < 1) | (nlay > nl)
               | (nc < border) | (nc >= w - border)
               | (nr < row_lo + border) | (nr >= row_hi - border))
        alive = alive & ~(active & (diverged | (move & oob)))
        converged = converged | (active & conv_now)
        safe = ~oob
        lay = jnp.where(move & safe, nlay, lay)
        rr = jnp.where(move & safe, nr, rr)
        cc = jnp.where(move & safe, nc, cc)

    alive = alive & converged  # non-convergence rejects (sift.cpp:351)

    # final contrast + edge tests at the converged location
    (d0, d1, d2, dxx, dxy, _dxs, dyy, _dys, _dss,
     center) = fetch(lay, rr, cc)
    t = d0 * xc + d1 * xr + d2 * xi
    contr = center * _IMG_SCALE + t * 0.5
    alive = alive & (jnp.abs(contr) * nl >= cfg.contrast_threshold)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = cfg.edge_threshold
    alive = alive & (det > 0) & (tr * tr * e < (e + 1) * (e + 1) * det)
    return Refined(lay, rr, cc, xi, xr, xc, contr, alive)
