"""Schur-complement bundle adjustment, batched and static-shaped.

Levenberg-Marquardt over cameras (axis-angle + translation, 6 dof) and
3-D points, minimizing masked Huber-robust reprojection error in
normalized image coordinates.

Design (vs. the classic sparse-Cholesky BA):
  * The point block Hpp is block-diagonal (3x3 per point) — inverted
    in closed form, batched.
  * The reduced camera (Schur) system S dx_c = rhs is solved
    **matrix-free with conjugate gradients**: each application of S is
    two per-observation block matvecs + two segment-sums + one batched
    3x3 solve. No S matrix is ever materialized, so the same code
    shards over a device mesh by splitting the observation table and
    psum-ing the segment-sum outputs (parallel/ba.py).
  * All shapes static: observations are a fixed-capacity masked table;
    LM runs a fixed iteration count with where-based accept/reject
    (no data-dependent control flow).

Cameras can be frozen via `fixed_cams` (gauge fixing).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sift_tpu.geometry.lie import so3_exp
from sift_tpu.utils.precision import highest_precision


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem.

    cameras: (C, 6)  [w | t], world->camera, normalized coords
    points:  (P, 3)  world points
    cam_idx: (O,) int32 observation camera indices
    pt_idx:  (O,) int32 observation point indices
    uv:      (O, 2) observed normalized image coords
    mask:    (O,) bool valid-observation mask
    fixed_cams: (C,) bool — cameras excluded from the update (gauge)
    """
    cameras: jnp.ndarray
    points: jnp.ndarray
    cam_idx: jnp.ndarray
    pt_idx: jnp.ndarray
    uv: jnp.ndarray
    mask: jnp.ndarray
    fixed_cams: jnp.ndarray


@highest_precision
def _project_one(cam: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Normalized-coordinate projection of one point by one camera."""
    r = so3_exp(cam[:3])
    xc = r @ x + cam[3:]
    z = jnp.where(jnp.abs(xc[2]) > 1e-9, xc[2], 1e-9)
    return xc[:2] / z


def _residual_one(cam, x, uv):
    return _project_one(cam, x) - uv


def _robust_weight(r2: jnp.ndarray, delta: float, loss: str
                   ) -> jnp.ndarray:
    """IRLS weight on squared residual norms.

    huber: constant gradient beyond delta (Ceres default shape);
    cauchy: redescending — gross outliers' influence -> 0.
    """
    if loss == "none":
        return jnp.ones_like(r2)
    if loss == "cauchy":
        return 1.0 / (1.0 + r2 / (delta * delta))
    rn = jnp.sqrt(r2 + 1e-20)
    return jnp.where(rn <= delta, 1.0, delta / rn)


def _inv3x3_sym(h: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form inverse of symmetric PD (..., 3, 3)."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 1], h[..., 1, 2], h[..., 2, 2]
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    det = a * c00 + b * c01 + c * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    row0 = jnp.stack([c00, c01, c02], axis=-1)
    row1 = jnp.stack([c01, c11, c12], axis=-1)
    row2 = jnp.stack([c02, c12, c22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def _build_system(prob: BAProblem, huber_delta: float, loss: str):
    """Per-observation Jacobian blocks and robust weights.

    Returns (jc (O,2,6), jp (O,2,3), res (O,2), w (O,)).
    """
    cams_o = prob.cameras[prob.cam_idx]
    pts_o = prob.points[prob.pt_idx]

    res = jax.vmap(_residual_one)(cams_o, pts_o, prob.uv)
    jc = jax.vmap(jax.jacfwd(_residual_one, argnums=0))(
        cams_o, pts_o, prob.uv)
    jp = jax.vmap(jax.jacfwd(_residual_one, argnums=1))(
        cams_o, pts_o, prob.uv)
    w = _robust_weight(jnp.sum(res * res, axis=-1), huber_delta, loss)
    w = w * prob.mask.astype(jnp.float32)
    return jc, jp, res, w


def _cost(prob: BAProblem, huber_delta: float, loss: str,
          psum=None) -> jnp.ndarray:
    cams_o = prob.cameras[prob.cam_idx]
    pts_o = prob.points[prob.pt_idx]
    res = jax.vmap(_residual_one)(cams_o, pts_o, prob.uv)
    r2 = jnp.sum(res * res, axis=-1)
    d2 = huber_delta * huber_delta
    if loss == "none":
        rho = 0.5 * r2
    elif loss == "cauchy":
        rho = 0.5 * d2 * jnp.log1p(r2 / d2)
    else:
        rn = jnp.sqrt(r2 + 1e-20)
        rho = jnp.where(rn <= huber_delta, 0.5 * r2,
                        huber_delta * (rn - 0.5 * huber_delta))
    total = jnp.sum(rho * prob.mask.astype(jnp.float32))
    return psum(total) if psum is not None else total


_SAME = object()


@highest_precision
def _lm_step(prob: BAProblem, lam: jnp.ndarray, huber_delta: float,
             loss: str, cg_iters: int, psum=None, psum_pt=_SAME):
    """One damped Schur/CG step. Returns (dcams (C,6), dpts (P,3)).

    `psum` optionally reduces observation-sharded segment sums across
    a mesh axis (parallel/ba.py passes lax.psum); None on one chip.
    `psum_pt` separately controls the POINT-side reductions: for
    observation sharding it equals `psum` (points replicated); for
    point sharding it is None — each device owns its point block and
    only camera-side reductions cross the mesh.
    """
    if psum_pt is _SAME:
        psum_pt = psum
    c = prob.cameras.shape[0]
    p = prob.points.shape[0]
    jc, jp, res, w = _build_system(prob, huber_delta, loss)
    wc = w[:, None, None]

    def seg_cam(x):  # (O, ...) -> (C, ...)
        out = jax.ops.segment_sum(x, prob.cam_idx, num_segments=c)
        return psum(out) if psum is not None else out

    def seg_pt(x):   # (O, ...) -> (P, ...)
        out = jax.ops.segment_sum(x, prob.pt_idx, num_segments=p)
        return psum_pt(out) if psum_pt is not None else out

    # normal-equation blocks
    hcc = seg_cam(wc * jnp.einsum("ori,orj->oij", jc, jc))   # (C,6,6)
    hpp = seg_pt(wc * jnp.einsum("ori,orj->oij", jp, jp))    # (P,3,3)
    bc = -seg_cam(jnp.einsum("ori,or->oi", jc, res * w[:, None]))
    bp = -seg_pt(jnp.einsum("ori,or->oi", jp, res * w[:, None]))
    wcp = wc * jnp.einsum("ori,orj->oij", jc, jp)            # (O,6,3)

    # damping (LM, multiplicative on block diagonals)
    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    hcc_d = hcc + lam * eye6 * jnp.maximum(
        jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hcc)), 1e-6)
    hpp_d = hpp + lam * eye3 * jnp.maximum(
        jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(hpp)), 1e-6)
    hpp_inv = _inv3x3_sym(hpp_d)

    free = ~prob.fixed_cams

    def mask_cam(x):                                         # (C, 6)
        return x * free[:, None].astype(x.dtype)

    def schur_apply(xc):
        """S xc = Hcc xc - Hcp Hpp^-1 Hpc xc, xc: (C, 6)."""
        xc = mask_cam(xc)
        y = jnp.einsum("oij,oi->oj", wcp, xc[prob.cam_idx])  # (O, 3)
        z = seg_pt(y)                                        # (P, 3)
        u = jnp.einsum("pij,pj->pi", hpp_inv, z)             # (P, 3)
        v = jnp.einsum("oij,oj->oi", wcp, u[prob.pt_idx])    # (O, 6)
        out = jnp.einsum("cij,cj->ci", hcc_d, xc) - seg_cam(v)
        return mask_cam(out)

    # Schur RHS: bc - Hcp Hpp^-1 bp
    u0 = jnp.einsum("pij,pj->pi", hpp_inv, bp)
    rhs = mask_cam(bc - seg_cam(
        jnp.einsum("oij,oj->oi", wcp, u0[prob.pt_idx])))

    # CG on the reduced camera system (fixed iterations, masked dofs)
    def dot(a, b):
        return jnp.sum(a * b)

    def cg_body(_, state):
        x, r, pdir, rs = state
        ap = schur_apply(pdir)
        denom = dot(pdir, ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-20, rs / denom, 0.0)
        x = x + alpha * pdir
        r = r - alpha * ap
        rs_new = dot(r, r)
        beta = jnp.where(rs > 1e-20, rs_new / rs, 0.0)
        pdir = r + beta * pdir
        return x, r, pdir, rs_new

    x0 = jnp.zeros_like(rhs)
    state = (x0, rhs, rhs, dot(rhs, rhs))
    dc, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body, state)
    dc = mask_cam(dc)

    # back-substitute points: dp = Hpp^-1 (bp - Hpc dc)
    y = jnp.einsum("oij,oi->oj", wcp, dc[prob.cam_idx])
    dp = jnp.einsum("pij,pj->pi", hpp_inv, bp - seg_pt(y))
    return dc, dp


@highest_precision
def bundle_adjust_loop(prob: BAProblem, iters: int, cg_iters: int,
                       huber_delta: float, loss: str, lam0: float,
                       psum=None, psum_pt=_SAME) -> BAProblem:
    """LM loop shared by the single-chip and sharded adjusters.

    With `psum`, the observation table is assumed sharded over a mesh
    axis: every cross-observation reduction — normal-equation blocks,
    Schur/CG matvecs, costs — is psum-ed, so each device computes the
    identical update. With `psum_pt=None` on top, points (and their
    observations) are device-local map blocks: point-side reductions
    stay on-device and only the camera system crosses the mesh.
    """

    def body(_, carry):
        prob, lam = carry
        dc, dp = _lm_step(prob, lam, huber_delta, loss, cg_iters,
                          psum=psum, psum_pt=psum_pt)
        cand = prob._replace(cameras=prob.cameras + dc,
                             points=prob.points + dp)
        c0 = _cost(prob, huber_delta, loss, psum=psum)
        c1 = _cost(cand, huber_delta, loss, psum=psum)
        accept = (c1 < c0) & jnp.isfinite(c1)
        new_prob = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, b, a), prob, cand)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 4.0, 1e3))
        return new_prob, lam

    prob, _ = jax.lax.fori_loop(0, iters, body,
                                (prob, jnp.float32(lam0)))
    return prob


@functools.partial(jax.jit,
                   static_argnames=("iters", "cg_iters", "huber_delta",
                                    "loss"))
def bundle_adjust(prob: BAProblem, iters: int = 20, cg_iters: int = 30,
                  huber_delta: float = 3e-3, loss: str = "huber",
                  lam0: float = 1e-3) -> BAProblem:
    """Run LM bundle adjustment; returns the problem with updated
    cameras/points. Fixed iteration count, accept/reject by cost."""
    return bundle_adjust_loop(prob, iters, cg_iters, huber_delta, loss,
                              lam0)


def reproj_rmse(prob: BAProblem) -> jnp.ndarray:
    """Masked RMS reprojection error (normalized coords)."""
    cams_o = prob.cameras[prob.cam_idx]
    pts_o = prob.points[prob.pt_idx]
    res = jax.vmap(_residual_one)(cams_o, pts_o, prob.uv)
    m = prob.mask.astype(jnp.float32)
    se = jnp.sum(jnp.sum(res * res, axis=-1) * m)
    return jnp.sqrt(se / jnp.maximum(jnp.sum(m), 1.0))
