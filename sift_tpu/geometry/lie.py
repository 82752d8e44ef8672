"""SO(3)/SE(3) utilities for pose estimation, BA and pose graphs.

New capability (no reference counterpart — the reference stops at a
2-D homography, src/main.cpp:54). All functions are batched-friendly
(vmap over leading axes) and Taylor-guarded near theta = 0 so they are
safe under jit/grad.
"""

from __future__ import annotations

import jax.numpy as jnp
from sift_tpu.utils.precision import highest_precision

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (3,) -> (3, 3) skew-symmetric."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy]),
        jnp.stack([wz, z, -wx]),
        jnp.stack([-wy, wx, z]),
    ])


@highest_precision
def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation matrix (3, 3)."""
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    k = hat(w)
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta,
                  1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2,
                  0.5 - theta2 / 24.0)
    return jnp.eye(3) + a * k + b * (k @ k)


def so3_log(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (3, 3) -> axis-angle (3,)."""
    cos_t = jnp.clip((jnp.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    w = jnp.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                   r[1, 0] - r[0, 1]]) * 0.5
    scale = jnp.where(theta > 1e-6, theta / jnp.sin(theta + _EPS), 1.0)
    return w * scale


@highest_precision
def se3_apply(r: jnp.ndarray, t: jnp.ndarray, x: jnp.ndarray
              ) -> jnp.ndarray:
    """Apply (R, t) to points x (..., 3)."""
    return x @ r.T + t


def project(r: jnp.ndarray, t: jnp.ndarray, k: jnp.ndarray,
            x: jnp.ndarray) -> jnp.ndarray:
    """Pinhole projection of world points x (..., 3) -> pixels (..., 2)."""
    xc = se3_apply(r, t, x)
    z = jnp.where(jnp.abs(xc[..., 2]) > 1e-9, xc[..., 2], 1e-9)
    u = k[0, 0] * xc[..., 0] / z + k[0, 2]
    v = k[1, 1] * xc[..., 1] / z + k[1, 2]
    return jnp.stack([u, v], axis=-1)
