"""Two-view epipolar geometry: essential matrix RANSAC + pose recovery.

New capability per the north star (the reference stops at homography).
Same batched shape as geometry/homography.py: a fixed, seeded batch
of minimal samples solved in parallel by vmap, masked inlier counting,
no data-dependent iteration.

Two minimal solvers, both batched under vmap:
  * "5pt" (default): Nistér's 5-point (geometry/fivepoint.py) — up to
    10 essential candidates per minimal sample via a degree-10
    polynomial solved with fixed-iteration Durand-Kerner (XLA has no
    nonsymmetric eig). At low inlier ratios (real loop closures) a
    5-point sample survives contamination ~(1/w)^3 more often than an
    8-point sample, so far fewer hypotheses reach the same inlier set.
  * "8pt": the normalized linear 8-point fallback (one candidate per
    sample, no polynomial machinery).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sift_tpu.geometry.triangulation import triangulate
from sift_tpu.geometry.linalg import smallest_eigvec
from sift_tpu.geometry.lie import hat, so3_exp, so3_log
from sift_tpu.utils.precision import highest_precision


class EssentialResult(NamedTuple):
    E: jnp.ndarray          # (3, 3)
    R: jnp.ndarray          # (3, 3) pose of cam1 w.r.t. cam0
    t: jnp.ndarray          # (3,) unit translation
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray         # () bool


@highest_precision
def _eight_point(p0: jnp.ndarray, p1: jnp.ndarray) -> jnp.ndarray:
    """Essential matrix from 8 normalized correspondences (8, 2) each.

    Linear 8-point + projection onto the essential manifold
    (two equal singular values, third zero).
    """
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    o = jnp.ones_like(x0)
    a = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                   x0, y0, o], axis=1)                     # (8, 9)
    ata = a.T @ a
    e = smallest_eigvec(ata).reshape(3, 3)
    u, s, vt = jnp.linalg.svd(e)
    sm = (s[0] + s[1]) * 0.5
    return (u * jnp.array([sm, sm, 0.0])) @ vt


@highest_precision
def _sampson_sq(e: jnp.ndarray, p0: jnp.ndarray, p1: jnp.ndarray
                ) -> jnp.ndarray:
    """Squared Sampson distance in normalized coords: (N,)."""
    p0h = jnp.concatenate([p0, jnp.ones_like(p0[:, :1])], axis=1)
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)
    ep0 = p0h @ e.T                                        # (N, 3)
    etp1 = p1h @ e                                         # (N, 3)
    num = jnp.sum(p1h * ep0, axis=1) ** 2
    den = ep0[:, 0] ** 2 + ep0[:, 1] ** 2 \
        + etp1[:, 0] ** 2 + etp1[:, 1] ** 2
    err = num / jnp.maximum(den, 1e-12)
    return jnp.where(jnp.isfinite(err), err, jnp.inf)


@highest_precision
def _decompose(e: jnp.ndarray, p0: jnp.ndarray, p1: jnp.ndarray,
               mask: jnp.ndarray):
    """Pick the (R, t) among the 4 decompositions with the most
    points in front of both cameras (cv::recoverPose semantics)."""
    u, _, vt = jnp.linalg.svd(e)
    # enforce proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    tt = u[:, 2]
    eye = jnp.eye(3)
    zero = jnp.zeros(3)

    def cheirality(r, t):
        x = triangulate(eye, zero, r, t, p0, p1)
        z0 = x[:, 2]
        x1 = x @ r.T + t
        z1 = x1[:, 2]
        good = (z0 > 0) & (z1 > 0) & mask
        return jnp.sum(good.astype(jnp.int32))

    cands = ((r1, tt), (r1, -tt), (r2, tt), (r2, -tt))
    counts = jnp.stack([cheirality(r, t) for r, t in cands])
    best = jnp.argmax(counts)
    rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return rs[best], ts[best], counts[best]


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "solver"))
@highest_precision
def find_essential_ransac(p0: jnp.ndarray, p1: jnp.ndarray,
                          valid: Optional[jnp.ndarray] = None,
                          threshold: float = 1e-3,
                          n_hypotheses: int = 1024,
                          seed: int = 0,
                          solver: str = "5pt") -> EssentialResult:
    """RANSAC essential matrix from normalized image coords (N, 2) x2.

    threshold is on Sampson distance in normalized coordinates
    (~pixel_thresh / focal_length). solver: "5pt" (Nistér minimal,
    up to 10 candidates per sample) or "8pt" (linear fallback).
    """
    n = p0.shape[0]
    p0 = p0.astype(jnp.float32)
    p1 = p1.astype(jnp.float32)
    if valid is None:
        valid = jnp.ones((n,), bool)

    key = jax.random.PRNGKey(seed)
    # the 5pt solver emits up to 10 candidates per sample; fewer
    # samples reach the same model count
    n_samples = (max(n_hypotheses // 8, 32) if solver == "5pt"
                 else n_hypotheses)
    g = jax.random.gumbel(key, (n_samples, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, samples = jax.lax.top_k(g, 5 if solver == "5pt" else 8)

    if solver == "5pt":
        from sift_tpu.geometry.fivepoint import essential_candidates_5pt

        def hypothesis(idx):
            cand, cvalid = essential_candidates_5pt(p0[idx], p1[idx])
            errs = jax.vmap(lambda e: _sampson_sq(e, p0, p1))(cand)
            inl = (errs < threshold * threshold) & valid[None, :]
            cnt = jnp.sum(inl.astype(jnp.int32), axis=1) \
                * cvalid.astype(jnp.int32)
            k = jnp.argmax(cnt)
            return cnt[k], cand[k]
    else:
        def hypothesis(idx):
            e = _eight_point(p0[idx], p1[idx])
            err = _sampson_sq(e, p0, p1)
            inl = (err < threshold * threshold) & valid
            return jnp.sum(inl.astype(jnp.int32)), e

    counts, es = jax.lax.map(hypothesis, samples,
                             batch_size=min(256, n_samples))
    best = jnp.argmax(counts)
    e_best = es[best]
    inliers = (_sampson_sq(e_best, p0, p1) < threshold * threshold) & valid
    ok = counts[best] >= 8

    # locally-optimized RANSAC: iterate (masked least-squares refit on
    # the inlier set -> recompute inliers), keeping the best model
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    o = jnp.ones_like(x0)
    a_full = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                        x0, y0, o], axis=1)

    def refit(mask):
        a = a_full * mask[:, None].astype(jnp.float32)
        e = smallest_eigvec(a.T @ a).reshape(3, 3)
        u, s, vt = jnp.linalg.svd(e)
        sm = (s[0] + s[1]) * 0.5
        return (u * jnp.array([sm, sm, 0.0])) @ vt

    for _ in range(3):
        e_ref = refit(inliers)
        inl_ref = (_sampson_sq(e_ref, p0, p1)
                   < threshold * threshold) & valid
        better = jnp.sum(inl_ref) >= jnp.sum(inliers)
        e_best = jnp.where(better, e_ref, e_best)
        inliers = jnp.where(better, inl_ref, inliers)

    r, t, _ = _decompose(e_best, p0, p1, inliers)

    # Gauss-Newton polish on the 5-dof pose (the linear refit's
    # algebraic cost is biased; GN on the Sampson error reaches the
    # noise floor). Parameterized as E(w, t) = [t/|t|]_x exp(w).
    def pose_e(params):
        w, tv = params[:3], params[3:]
        tv = tv / jnp.maximum(jnp.linalg.norm(tv), 1e-12)
        return hat(tv) @ so3_exp(w)

    def residuals(params):
        e = pose_e(params)
        p0h = jnp.concatenate([p0, jnp.ones_like(p0[:, :1])], axis=1)
        p1h = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)
        ep0 = p0h @ e.T
        etp1 = p1h @ e
        num = jnp.sum(p1h * ep0, axis=1)
        den = jnp.sqrt(ep0[:, 0] ** 2 + ep0[:, 1] ** 2
                       + etp1[:, 0] ** 2 + etp1[:, 1] ** 2 + 1e-12)
        return (num / den) * inliers.astype(jnp.float32)

    def gn_step(_, params):
        res = residuals(params)
        j = jax.jacfwd(residuals)(params)          # (N, 6)
        jtj = j.T @ j + 1e-8 * jnp.eye(6)
        delta = jnp.linalg.solve(jtj, j.T @ res)
        cand = params - delta
        return jnp.where(jnp.all(jnp.isfinite(cand)), cand, params)

    params0 = jnp.concatenate([so3_log(r), t])
    params = jax.lax.fori_loop(0, 5, gn_step, params0)
    e_gn = pose_e(params)
    inl_gn = (_sampson_sq(e_gn, p0, p1) < threshold * threshold) & valid
    better = jnp.sum(inl_gn) >= jnp.sum(inliers)
    e_best = jnp.where(better, e_gn, e_best)
    inliers = jnp.where(better, inl_gn, inliers)
    r2, t2, _ = _decompose(e_best, p0, p1, inliers)

    return EssentialResult(e_best, r2, t2, inliers & ok,
                           jnp.sum(inliers.astype(jnp.int32))
                           * ok.astype(jnp.int32), ok)
