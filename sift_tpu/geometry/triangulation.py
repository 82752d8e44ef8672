"""Linear (DLT) triangulation, batched.

New capability per the north star. Points are triangulated from two
views via the homogeneous DLT system solved as the smallest
eigenvector of a 4x4 A^T A per point — closed-form-sized eigh, vmapped
over all correspondences at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from sift_tpu.geometry.linalg import smallest_eigvec
from sift_tpu.utils.precision import highest_precision


def _projection_matrix(r: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(3, 4) projection [R | t] in normalized camera coords."""
    return jnp.concatenate([r, t[:, None]], axis=1)


@highest_precision
def triangulate(r0: jnp.ndarray, t0: jnp.ndarray,
                r1: jnp.ndarray, t1: jnp.ndarray,
                p0: jnp.ndarray, p1: jnp.ndarray) -> jnp.ndarray:
    """Triangulate (N, 2) normalized coords from two posed views.

    Returns (N, 3) points in the world (camera-0 if r0=I,t0=0) frame.
    """
    m0 = _projection_matrix(r0, t0)
    m1 = _projection_matrix(r1, t1)

    def one(q0, q1):
        a = jnp.stack([
            q0[0] * m0[2] - m0[0],
            q0[1] * m0[2] - m0[1],
            q1[0] * m1[2] - m1[0],
            q1[1] * m1[2] - m1[1],
        ])                                               # (4, 4)
        x = smallest_eigvec(a.T @ a)
        w = jnp.where(jnp.abs(x[3]) > 1e-12, x[3], 1e-12)
        return x[:3] / w

    return jax.vmap(one)(p0.astype(jnp.float32), p1.astype(jnp.float32))


@highest_precision
def reprojection_error(r: jnp.ndarray, t: jnp.ndarray,
                       x: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Per-point normalized-coordinate reprojection error (N,)."""
    xc = x @ r.T + t
    z = jnp.where(jnp.abs(xc[:, 2]) > 1e-9, xc[:, 2], 1e-9)
    proj = xc[:, :2] / z[:, None]
    return jnp.linalg.norm(proj - p, axis=-1)
