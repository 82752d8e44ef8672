"""RANSAC homography estimation (replaces reference C12).

The reference delegates to cv::findHomography(obj, scene, RANSAC)
(src/main.cpp:54) and cv::perspectiveTransform (src/main.cpp:62).
This module owns both, built for batched execution:

  * Hypotheses are evaluated **in parallel**: a fixed batch of minimal
    4-point samples (seeded, deterministic — SURVEY.md §7 hard part e)
    is drawn with a Gumbel-top-4 trick over the validity mask, each
    solved by a vmapped 8x8 DLT, and all inlier counts computed in one
    shot — the data-parallel inversion of OpenCV's sequential
    early-exit RANSAC loop (vmap over hypotheses instead of a
    data-dependent while loop).
  * The winning hypothesis is refined by a masked normalized DLT over
    its full inlier set (9x9 eigen-solve of A^T A — no big SVD), then
    polished with Gauss-Newton on the reprojection error, mirroring
    OpenCV's LM refinement step.

Inlier test: squared forward-transfer error < threshold^2, matching
cv::findHomography's RANSAC cost (default threshold 3.0 px).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from sift_tpu.geometry.linalg import smallest_eigvec
from sift_tpu.utils.precision import highest_precision


class HomographyResult(NamedTuple):
    H: jnp.ndarray           # (3, 3) float32, H[2,2] == 1
    inliers: jnp.ndarray     # (N,) bool
    n_inliers: jnp.ndarray   # () int32
    ok: jnp.ndarray          # () bool — a non-degenerate model was found


def perspective_transform(pts: jnp.ndarray, H: jnp.ndarray) -> jnp.ndarray:
    """cv::perspectiveTransform twin: (..., 2) points through 3x3 H."""
    x, y = pts[..., 0], pts[..., 1]
    w = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    w = jnp.where(jnp.abs(w) > 1e-12, w, jnp.inf)
    u = (H[0, 0] * x + H[0, 1] * y + H[0, 2]) / w
    v = (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / w
    return jnp.stack([u, v], axis=-1)


def _dlt4(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 correspondences: solve the 8x8 system
    A h = b with h9 = 1. src/dst: (4, 2). Returns (3, 3)."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, o, z, z, z, -u * x, -u * y], axis=1)
    rows_v = jnp.stack([z, z, z, x, y, o, -v * x, -v * y], axis=1)
    a = jnp.concatenate([rows_u, rows_v], axis=0)          # (8, 8)
    b = jnp.concatenate([u, v], axis=0)                    # (8,)
    h = jnp.linalg.solve(a, b)
    return jnp.concatenate([h, jnp.ones((1,), h.dtype)]).reshape(3, 3)


def _sq_transfer_err(H: jnp.ndarray, src: jnp.ndarray, dst: jnp.ndarray
                     ) -> jnp.ndarray:
    """Squared forward-transfer error per correspondence: (N,)."""
    proj = perspective_transform(src, H)
    d = proj - dst
    err = jnp.sum(d * d, axis=-1)
    return jnp.where(jnp.isfinite(err), err, jnp.inf)


def _normalization(pts: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Hartley normalization transform over masked points: (3, 3)."""
    w = mask.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1)) * w
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d) / n, 1e-12)
    return jnp.array([[1.0, 0.0, -mean[0]],
                      [0.0, 1.0, -mean[1]],
                      [0.0, 0.0, 1.0]]) * jnp.array(
        [[scale], [scale], [1.0]])


@highest_precision
def _dlt_masked(src: jnp.ndarray, dst: jnp.ndarray, mask: jnp.ndarray
                ) -> jnp.ndarray:
    """Least-squares DLT over all masked correspondences.

    Normalized (Hartley) for conditioning; solved via the smallest
    eigenvector of the 9x9 A^T A (batches well; avoids a tall SVD).
    """
    ts = _normalization(src, mask)
    td = _normalization(dst, mask)
    sh = perspective_transform(src, ts)
    dh = perspective_transform(dst, td)
    x, y = sh[:, 0], sh[:, 1]
    u, v = dh[:, 0], dh[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=1)
    rows_v = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], axis=1)
    a = jnp.concatenate([rows_u * mask[:, None].astype(x.dtype),
                         rows_v * mask[:, None].astype(x.dtype)], axis=0)
    ata = a.T @ a                                           # (9, 9)
    hn = smallest_eigvec(ata).reshape(3, 3)
    h = jnp.linalg.solve(td, hn @ ts)                       # denormalize
    return h / jnp.where(jnp.abs(h[2, 2]) > 1e-12, h[2, 2], 1.0)


@highest_precision
def _gauss_newton(H: jnp.ndarray, src: jnp.ndarray, dst: jnp.ndarray,
                  mask: jnp.ndarray, iters: int = 5) -> jnp.ndarray:
    """Polish H by Gauss-Newton on masked reprojection error
    (capability twin of OpenCV's LM refinement in findHomography)."""
    w = mask.astype(jnp.float32)

    def residual(h8, x, y):
        d = h8[6] * x + h8[7] * y + 1.0
        return jnp.stack([(h8[0] * x + h8[1] * y + h8[2]) / d,
                          (h8[3] * x + h8[4] * y + h8[5]) / d])

    def step(_, h8):
        def res_one(x, y, u, v):
            p = residual(h8, x, y)
            return jnp.stack([p[0] - u, p[1] - v])

        r = jax.vmap(res_one)(src[:, 0], src[:, 1],
                              dst[:, 0], dst[:, 1])         # (N, 2)

        def jac_one(x, y, u, v):
            return jax.jacfwd(lambda h: jnp.stack(
                [residual(h, x, y)[0] - u, residual(h, x, y)[1] - v]))(h8)

        j = jax.vmap(jac_one)(src[:, 0], src[:, 1],
                              dst[:, 0], dst[:, 1])         # (N, 2, 8)
        jw = j * w[:, None, None]
        jtj = jnp.einsum("nri,nrj->ij", jw, j)
        jtr = jnp.einsum("nri,nr->i", jw, r)
        delta = jnp.linalg.solve(jtj + 1e-8 * jnp.eye(8), jtr)
        out = h8 - delta
        return jnp.where(jnp.all(jnp.isfinite(out)), out, h8)

    h8 = jnp.concatenate([H[0], H[1], H[2, :2]]) / H[2, 2]
    h8 = jax.lax.fori_loop(0, iters, step, h8)
    return jnp.concatenate([h8, jnp.ones((1,))]).reshape(3, 3)


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "refine"))
@highest_precision
def find_homography_ransac(src: jnp.ndarray, dst: jnp.ndarray,
                           valid: Optional[jnp.ndarray] = None,
                           threshold: float = 3.0,
                           n_hypotheses: int = 1024,
                           seed: int = 0,
                           refine: bool = True) -> HomographyResult:
    """cv::findHomography(src, dst, RANSAC) twin, batched-hypothesis.

    src, dst: (N, 2) padded correspondence arrays; valid: (N,) mask.
    Deterministic for a given seed (fixed hypothesis count — no
    data-dependent iteration).
    """
    n = src.shape[0]
    src = src.astype(jnp.float32)
    dst = dst.astype(jnp.float32)
    if valid is None:
        valid = jnp.ones((n,), bool)

    key = jax.random.PRNGKey(seed)
    # Gumbel-top-4: per hypothesis, 4 distinct valid indices uniform
    g = jax.random.gumbel(key, (n_hypotheses, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, samples = jax.lax.top_k(g, 4)                        # (B, 4)

    def hypothesis(idx):
        h = _dlt4(src[idx], dst[idx])
        err = _sq_transfer_err(h, src, dst)
        inl = (err < threshold * threshold) & valid
        finite = jnp.all(jnp.isfinite(h))
        return jnp.where(finite, jnp.sum(inl.astype(jnp.int32)), 0), h

    counts, hs = jax.lax.map(hypothesis, samples,
                             batch_size=min(256, n_hypotheses))
    best = jnp.argmax(counts)
    h_best = hs[best]
    n_best = counts[best]
    ok = n_best >= 4

    inliers = (_sq_transfer_err(h_best, src, dst)
               < threshold * threshold) & valid
    if refine:
        h_ref = _dlt_masked(src, dst, inliers)
        h_ref = _gauss_newton(h_ref, src, dst, inliers)
        # accept refinement only if it keeps at least as many inliers
        inl_ref = (_sq_transfer_err(h_ref, src, dst)
                   < threshold * threshold) & valid
        better = (jnp.sum(inl_ref) >= jnp.sum(inliers)) & \
            jnp.all(jnp.isfinite(h_ref))
        h_best = jnp.where(better, h_ref, h_best)
        inliers = jnp.where(better, inl_ref, inliers)

    h_best = jnp.where(ok, h_best, jnp.eye(3))
    return HomographyResult(h_best, inliers & ok,
                            jnp.sum(inliers.astype(jnp.int32))
                            * ok.astype(jnp.int32), ok)
