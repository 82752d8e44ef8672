"""Global rotation averaging (chordal/spectral relaxation).

Given pairwise relative rotations R_ij (frame i -> frame j) from
two-view geometry, recover globally consistent absolute rotations —
the standard initializer for global SfM pipelines, complementing the
incremental driver (sfm/incremental.py) on unordered collections.

Batched formulation: the chordal L2 problem
    min_R  sum_e w_e || R_j - R_ij R_i ||_F^2 ,  R_i in SO(3)
relaxes to the three smallest eigenvectors of a (3N, 3N) symmetric
block Laplacian — assembled with one vectorized scatter-add, solved
with one dense `eigh` (cheap dense work; pose counts are small next to map
points), followed by per-block SVD projection onto SO(3) (vmapped 3x3
SVDs). Optional IRLS reweighting rounds give robustness to outlier
edges without any combinatorial machinery.

No reference counterpart (the reference ends at a homography demo);
north-star config 5 capability.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from sift_tpu.utils.precision import highest_precision


def _block_laplacian(n: int, ei: jnp.ndarray, ej: jnp.ndarray,
                     rel: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """(3N, 3N) chordal Laplacian: diag blocks deg_i*I3, off blocks
    -w_e R_ij^T / -w_e R_ij. One vectorized scatter-add (a serial
    per-edge loop would put an O(E) dependency chain on device)."""
    e = ei.shape[0]
    rw = rel * w[:, None, None]                       # (E, 3, 3)
    eye_w = jnp.eye(3)[None] * w[:, None, None]       # (E, 3, 3)
    # four 3x3 blocks per edge: (i,j) -R^T, (j,i) -R, (i,i)+wI, (j,j)+wI
    blocks = jnp.concatenate(
        [-jnp.transpose(rw, (0, 2, 1)), -rw, eye_w, eye_w], axis=0)
    bi = jnp.concatenate([ei, ej, ei, ej])            # block-row owner
    bj = jnp.concatenate([ej, ei, ei, ej])            # block-col owner
    off = jnp.arange(3)
    rows = (3 * bi)[:, None, None] + off[None, :, None]   # (4E, 3, 3)
    cols = (3 * bj)[:, None, None] + off[None, None, :]
    mat0 = jnp.zeros((3 * n, 3 * n), jnp.float32)
    return mat0.at[rows, cols].add(blocks)


@highest_precision
def _project_so3(m: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation to a 3x3 block (SVD with det correction).

    For blocks of the form R @ U (shared U), proj(R U) = R proj(U):
    the correction factor is CONSISTENT across blocks, so the shared
    gauge rotation survives projection and the anchor alignment below
    removes it exactly.
    """
    u, _, vt = jnp.linalg.svd(m)
    d = jnp.sign(jnp.linalg.det(u @ vt))
    return u @ jnp.diag(jnp.stack([1.0, 1.0, d])) @ vt


@functools.partial(jax.jit, static_argnames=("n_frames", "anchor"))
@highest_precision
def _solve(ei, ej, rel, w, n_frames: int, anchor: int):
    lap = _block_laplacian(n_frames, ei, ej, rel, w)
    _, vecs = jnp.linalg.eigh(lap)
    basis = vecs[:, :3].reshape(n_frames, 3, 3)        # (N, 3, 3)
    # block i of the eigenbasis is R_i @ U for a shared gauge U.
    # If U is improper (det -1), per-block SVD projection would flip
    # a noise-dependent axis per block — make U proper first by
    # negating one shared eigenvector column.
    flip = jnp.where(jnp.linalg.det(basis[anchor]) < 0, -1.0, 1.0)
    basis = basis.at[:, :, 0].multiply(flip)
    # projection keeps the (now proper) shared factor
    # (see _project_so3); anchor alignment removes it
    rots = jax.vmap(_project_so3)(basis)
    r0 = rots[anchor]
    return jnp.einsum("nij,kj->nik", rots, r0)


@jax.jit
@highest_precision
def _residuals(ei, ej, rel, rots):
    pred = jnp.einsum("eij,ejk->eik", rel, rots[ei])
    return jnp.sqrt(jnp.sum((rots[ej] - pred) ** 2,
                            axis=(1, 2)) + 1e-12)


def average_rotations(n_frames: int,
                      edges_i: np.ndarray, edges_j: np.ndarray,
                      rel_rot: np.ndarray,
                      weights: Optional[np.ndarray] = None,
                      anchor: int = 0,
                      irls_rounds: int = 2) -> np.ndarray:
    """Solve for (N, 3, 3) absolute rotations (world -> frame).

    rel_rot: (E, 3, 3) with R_j = rel_rot[e] @ R_i for edge (i, j).
    weights: (E,) edge confidences (e.g. inlier counts).
    irls_rounds: extra reweighted solves (w /= chordal residual) for
        outlier robustness; 0 = single spectral solve.
    The gauge is fixed by anchoring frame `anchor` to identity.
    """
    ei = jnp.asarray(np.asarray(edges_i), jnp.int32)
    ej = jnp.asarray(np.asarray(edges_j), jnp.int32)
    rel = jnp.asarray(np.asarray(rel_rot), jnp.float32)
    w = (jnp.ones(ei.shape[0], jnp.float32) if weights is None
         else jnp.asarray(np.asarray(weights), jnp.float32))
    w = w / jnp.maximum(jnp.max(w), 1e-12)

    rots = _solve(ei, ej, rel, w, n_frames, anchor)
    for _ in range(irls_rounds):
        res = _residuals(ei, ej, rel, rots)
        med = jnp.median(res)
        w_new = w / jnp.maximum(res / jnp.maximum(med, 1e-6), 1.0)
        rots = _solve(ei, ej, rel, w_new, n_frames, anchor)
    return np.asarray(rots)
