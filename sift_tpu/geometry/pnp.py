"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Used by incremental SfM to register new views against the map. Same
Batched RANSAC shape as homography/epipolar: a fixed seeded batch of
minimal samples (6-point DLT — the P3P quartic is hostile to batched
execution; thousands of parallel DLT hypotheses close the gap), masked
inlier counting, locally-optimized refit, Gauss-Newton polish on the
inlier reprojection error over the 6-dof pose.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sift_tpu.geometry.linalg import smallest_eigvec
from sift_tpu.geometry.lie import so3_exp, so3_log
from sift_tpu.utils.precision import highest_precision


class PnPResult(NamedTuple):
    R: jnp.ndarray          # (3, 3) world->camera
    t: jnp.ndarray          # (3,)
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray         # () bool


@highest_precision
def _dlt_pnp(x: jnp.ndarray, p: jnp.ndarray, w: jnp.ndarray):
    """Weighted DLT pose: world points x (N,3), normalized obs p (N,2),
    weights w (N,). Returns (R, t) with R orthogonalized by SVD.

    3-D points are centroid/scale-normalized before the solve (without
    it the 12x12 system is badly conditioned for deep scenes) and the
    projection matrix denormalized after.
    """
    cw = jnp.maximum(jnp.sum(w), 1e-9)
    cen = jnp.sum(x * w[:, None], axis=0) / cw
    spread = jnp.sum(jnp.linalg.norm(x - cen, axis=1) * w) / cw
    s = jnp.maximum(spread, 1e-9) / jnp.sqrt(3.0)
    x = (x - cen) / s
    zeros = jnp.zeros_like(x[:, 0])
    ones = jnp.ones_like(zeros)
    u, v = p[:, 0], p[:, 1]
    # rows for u: [X 1 0 -uX -u], layout P = [p11..p14; p21..p24; p31..p34]
    def row_u():
        return jnp.concatenate([
            x, ones[:, None], jnp.zeros_like(x), zeros[:, None],
            -u[:, None] * x, -u[:, None]], axis=1)
    def row_v():
        return jnp.concatenate([
            jnp.zeros_like(x), zeros[:, None], x, ones[:, None],
            -v[:, None] * x, -v[:, None]], axis=1)
    a = jnp.concatenate([row_u() * w[:, None], row_v() * w[:, None]],
                        axis=0)                             # (2N, 12)
    vec = smallest_eigvec(a.T @ a)                          # (12,)
    pm = vec.reshape(3, 4)
    # denormalize: P acts on original coords via x' = (x - cen)/s
    pm = jnp.concatenate(
        [pm[:, :3] / s, (pm[:, 3] - pm[:, :3] @ cen / s)[:, None]],
        axis=1)
    # fix sign: points must be in front (positive depth for the
    # weighted centroid)
    depth = pm[2, :3] @ cen + pm[2, 3]
    pm = pm * jnp.where(depth < 0, -1.0, 1.0)
    m = pm[:, :3]
    # orthogonalize: R = U V^T, scale = mean singular value
    uu, ss, vt = jnp.linalg.svd(m)
    d = jnp.sign(jnp.linalg.det(uu @ vt))
    r = (uu * jnp.array([1.0, 1.0, d])) @ vt
    scale = jnp.mean(ss * jnp.array([1.0, 1.0, d]))
    t = pm[:, 3] / jnp.where(jnp.abs(scale) > 1e-12, scale, 1e-12)
    return r, t


@highest_precision
def _planar_pnp(x: jnp.ndarray, p: jnp.ndarray, w: jnp.ndarray):
    """Weighted pose for (near-)coplanar points: the 6-point DLT's
    12x12 system drops rank when the sample lies on one plane (walls,
    floors, facades — ubiquitous in real maps), so RANSAC scores this
    homography-decomposition pose (IPPE-style) alongside it.

    Fit the best plane (weighted covariance eigenbasis), DLT the
    plane->image homography, factor H = [h1 h2 h3] into
    [r1 r2 t] / lambda with lambda = 2 / (|h1| + |h2|), orthonormalize
    [r1 r2 r1xr2] by SVD projection, then map back from plane
    coordinates to world: R = R_plane @ [b1 b2 n]^T, t = t_p - R cen.
    """
    cw = jnp.maximum(jnp.sum(w), 1e-9)
    cen = jnp.sum(x * w[:, None], axis=0) / cw
    xc = x - cen
    cov = (xc * w[:, None]).T @ xc / cw
    _, evecs = jnp.linalg.eigh(cov)            # ascending eigenvalues
    normal = evecs[:, 0]
    b = evecs[:, 1:]                           # (3, 2) plane basis
    # right-handed plane frame [b1 b2 n]
    normal = normal * jnp.sign(jnp.linalg.det(
        jnp.concatenate([b, normal[:, None]], axis=1)))
    m_w2p = jnp.concatenate([b, normal[:, None]], axis=1).T   # (3, 3)
    q = xc @ b                                  # (N, 2) plane coords
    scale = jnp.maximum(jnp.sum(jnp.linalg.norm(q, axis=1) * w) / cw,
                        1e-9)
    q = q / scale
    u, v = p[:, 0], p[:, 1]
    ones = jnp.ones_like(u)
    zeros = jnp.zeros_like(u)
    rows_u = jnp.stack([q[:, 0], q[:, 1], ones,
                        zeros, zeros, zeros,
                        -u * q[:, 0], -u * q[:, 1], -u], axis=1)
    rows_v = jnp.stack([zeros, zeros, zeros,
                        q[:, 0], q[:, 1], ones,
                        -v * q[:, 0], -v * q[:, 1], -v], axis=1)
    a = jnp.concatenate([rows_u * w[:, None], rows_v * w[:, None]],
                        axis=0)                 # (2N, 9)
    h = smallest_eigvec(a.T @ a).reshape(3, 3)
    h = jnp.concatenate([h[:, :2] / scale, h[:, 2:]], axis=1)
    # cheirality: the plane centroid projects to h3 — positive depth
    h = h * jnp.where(h[2, 2] < 0, -1.0, 1.0)
    n1 = jnp.linalg.norm(h[:, 0])
    n2 = jnp.linalg.norm(h[:, 1])
    lam = 2.0 / jnp.maximum(n1 + n2, 1e-12)
    r12 = h[:, :2] * lam
    r3 = jnp.cross(r12[:, 0], r12[:, 1])
    mr = jnp.concatenate([r12, r3[:, None]], axis=1)
    uu, _, vt = jnp.linalg.svd(mr)
    d = jnp.sign(jnp.linalg.det(uu @ vt))
    r_plane = (uu * jnp.array([1.0, 1.0, d])) @ vt
    t_p = h[:, 2] * lam
    r = r_plane @ m_w2p
    return r, t_p - r @ cen


@highest_precision
def _reproj_sq(r, t, x, p):
    xc = x @ r.T + t
    z = xc[:, 2]
    proj = xc[:, :2] / jnp.where(jnp.abs(z[:, None]) > 1e-9,
                                 z[:, None], 1e-9)
    err = jnp.sum((proj - p) ** 2, axis=-1)
    err = jnp.where(z > 1e-6, err, jnp.inf)   # behind camera = outlier
    return jnp.where(jnp.isfinite(err), err, jnp.inf)


@functools.partial(jax.jit, static_argnames=("n_hypotheses",))
@highest_precision
def pnp_ransac(x: jnp.ndarray, p: jnp.ndarray,
               valid: Optional[jnp.ndarray] = None,
               threshold: float = 2e-3,
               n_hypotheses: int = 512,
               seed: int = 0) -> PnPResult:
    """RANSAC PnP: world points x (N, 3), normalized obs p (N, 2)."""
    n = x.shape[0]
    x = x.astype(jnp.float32)
    p = p.astype(jnp.float32)
    if valid is None:
        valid = jnp.ones((n,), bool)
    vf = valid.astype(jnp.float32)

    key = jax.random.PRNGKey(seed)
    g = jax.random.gumbel(key, (n_hypotheses, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, samples = jax.lax.top_k(g, 6)

    def hypothesis(idx):
        # score both the general DLT pose and the planar-decomposition
        # pose: whichever explains more points wins — mixed scenes use
        # DLT, single-plane samples (where DLT drops rank) use planar
        rd, td = _dlt_pnp(x[idx], p[idx], jnp.ones((6,)))
        rp, tp = _planar_pnp(x[idx], p[idx], jnp.ones((6,)))
        nd = jnp.sum(((_reproj_sq(rd, td, x, p) < threshold * threshold)
                      & valid).astype(jnp.int32))
        np_ = jnp.sum(((_reproj_sq(rp, tp, x, p) < threshold * threshold)
                       & valid).astype(jnp.int32))
        use_p = np_ > nd
        return (jnp.maximum(nd, np_), jnp.where(use_p, rp, rd),
                jnp.where(use_p, tp, td))

    counts, rs, ts = jax.lax.map(hypothesis, samples,
                                 batch_size=min(256, n_hypotheses))
    best = jnp.argmax(counts)
    r_best, t_best = rs[best], ts[best]
    inliers = (_reproj_sq(r_best, t_best, x, p)
               < threshold * threshold) & valid
    ok = counts[best] >= 6

    # locally-optimized refit + GN polish (both solvers — an all-inlier
    # refit on a planar map degenerates the DLT exactly like a minimal
    # sample does)
    for _ in range(2):
        for solver in (_dlt_pnp, _planar_pnp):
            r_ref, t_ref = solver(x, p, inliers.astype(jnp.float32))
            inl_ref = (_reproj_sq(r_ref, t_ref, x, p)
                       < threshold * threshold) & valid
            better = jnp.sum(inl_ref) >= jnp.sum(inliers)
            r_best = jnp.where(better, r_ref, r_best)
            t_best = jnp.where(better, t_ref, t_best)
            inliers = jnp.where(better, inl_ref, inliers)

    wmask = inliers.astype(jnp.float32)

    def residuals(params):
        r = so3_exp(params[:3])
        xc = x @ r.T + params[3:]
        z = jnp.where(jnp.abs(xc[:, 2]) > 1e-9, xc[:, 2], 1e-9)
        proj = xc[:, :2] / z[:, None]
        return ((proj - p) * wmask[:, None]).reshape(-1)

    def gn(_, params):
        res = residuals(params)
        j = jax.jacfwd(residuals)(params)
        jtj = j.T @ j + 1e-9 * jnp.eye(6)
        cand = params - jnp.linalg.solve(jtj, j.T @ res)
        return jnp.where(jnp.all(jnp.isfinite(cand)), cand, params)

    params = jnp.concatenate([so3_log(r_best), t_best])
    params = jax.lax.fori_loop(0, 5, gn, params)
    r_gn = so3_exp(params[:3])
    t_gn = params[3:]
    inl_gn = (_reproj_sq(r_gn, t_gn, x, p) < threshold * threshold) & valid
    better = jnp.sum(inl_gn) >= jnp.sum(inliers)
    r_best = jnp.where(better, r_gn, r_best)
    t_best = jnp.where(better, t_gn, t_best)
    inliers = jnp.where(better, inl_gn, inliers)

    return PnPResult(r_best, t_best, inliers & ok,
                     jnp.sum(inliers.astype(jnp.int32))
                     * ok.astype(jnp.int32), ok)
