"""Small-matrix linear algebra helpers shared by the geometry stack.

A float32 eigh on an accelerator need not match LAPACK's accuracy,
and minimal solvers whose answer IS the nullspace break on a loose
one. We polish the smallest eigenvector with a few inverse-power
iterations — each a tiny dense solve — which restores
near-machine-precision nullspaces while staying batched/vmappable.
"""

from __future__ import annotations

import jax.numpy as jnp


def smallest_eigvec(ata: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD ata.

    eigh seed + `iters` inverse-power iterations on (ata + eps I).
    """
    n = ata.shape[-1]
    _, vecs = jnp.linalg.eigh(ata)
    v = vecs[..., :, 0]
    eps = 1e-7 * jnp.trace(ata) / n + 1e-30
    a = ata + eps * jnp.eye(n, dtype=ata.dtype)
    for _ in range(iters):
        v = jnp.linalg.solve(a, v)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True),
                            1e-30)
    return v
