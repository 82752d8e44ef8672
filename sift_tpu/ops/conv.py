"""Gaussian blur for scale-space construction (replaces reference C4/C5).

The reference's live path is a naive O(H*W*k^2) 2-D convolution
(Gaussian_Blur, src/sift.cpp:123-153). Its 2-D kernel is the analytic
Gaussian truncated at radius floor(3*sigma) and NOT renormalized
(src/sift.cpp:95-108) — which factors exactly into two 1-D truncated
Gaussians, so we run it separably: two XLA convolutions (float32 at
full precision), with all scales of an octave batched into the channel
dimension (the base-relative sigma scheme, src/sift.cpp:241-258, makes
octave layers independent).

Boundary semantics: zero padding, with the reference's getSubMatrix
off-by-one (reads at row/col >= dim-1 yield 0, src/sift.cpp:116) —
reproduced by zeroing the input's last row/column before convolving.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Truncated, unnormalized 1-D Gaussian; float32, radius floor(3s).

    Product of two of these equals the reference's 2-D kernel
    (src/sift.cpp:101-105) up to float32 rounding of the x8192 scaling.
    """
    w = int(math.floor(3 * sigma))
    i = np.arange(-w, w + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma)) / math.sqrt(
        2.0 * math.pi * sigma * sigma)
    return k.astype(np.float32)


def _stack_kernels(sigmas: Sequence[float]) -> Tuple[np.ndarray, int]:
    """Zero-pad per-sigma 1-D kernels to a common odd width, centered.

    Zero taps are exact no-ops, so batching different kernel sizes into
    one conv is lossless.
    """
    ks = [gaussian_kernel_1d(s) for s in sigmas]
    kmax = max(k.shape[0] for k in ks)
    out = np.zeros((len(ks), kmax), np.float32)
    for i, k in enumerate(ks):
        off = (kmax - k.shape[0]) // 2
        out[i, off:off + k.shape[0]] = k
    return out, kmax // 2


def _zero_last_row_col(img: jnp.ndarray) -> jnp.ndarray:
    """Reproduce the getSubMatrix boundary quirk (src/sift.cpp:116)."""
    img = jnp.asarray(img)
    return img.at[-1, :].set(0.0).at[:, -1].set(0.0)


def gaussian_blur_multi_batch(imgs: jnp.ndarray,
                              sigmas: Sequence[float]) -> jnp.ndarray:
    """Blur a batch of images with several sigmas: (B, H, W) -> (B, S, H, W).

    Same math as gaussian_blur_multi with the frame batch riding the
    conv's N dimension (the single-device throughput path batches
    frames to fill the device; small octaves underfill it one frame at
    a time).
    """
    kmat, w = _stack_kernels(sigmas)
    s = kmat.shape[0]
    x = imgs.astype(jnp.float32)
    x = x.at[:, -1, :].set(0.0).at[:, :, -1].set(0.0)  # getSubMatrix quirk
    x = x[:, None]                                     # (B, 1, H, W)
    rhs_v = jnp.asarray(kmat)[:, None, :, None]
    v = jax.lax.conv_general_dilated(
        x, rhs_v, window_strides=(1, 1),
        padding=((w, w), (0, 0)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)           # (B, S, H, W)
    rhs_h = jnp.asarray(kmat)[:, None, None, :]
    h = jax.lax.conv_general_dilated(
        v, rhs_h, window_strides=(1, 1),
        padding=((0, 0), (w, w)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=s,
        precision=jax.lax.Precision.HIGHEST)           # (B, S, H, W)
    return h


def gaussian_blur_multi(img: jnp.ndarray,
                        sigmas: Sequence[float],
                        apply_quirk: bool = True) -> jnp.ndarray:
    """Blur one image with several sigmas at once: (H, W) -> (S, H, W).

    Functional twin of S calls to Gaussian_Blur (src/sift.cpp:123-153),
    run as one separable batched convolution. apply_quirk=False skips
    the last-row/col zeroing (spatially-tiled callers pre-apply it at
    the GLOBAL image edge; a tile's last row is usually interior).
    """
    kmat, w = _stack_kernels(sigmas)
    s = kmat.shape[0]
    x = img.astype(jnp.float32)
    if apply_quirk:
        x = _zero_last_row_col(x)
    x = x[None, None]                                 # (1,1,H,W)
    # vertical pass: out channels = S
    rhs_v = jnp.asarray(kmat)[:, None, :, None]   # (S, 1, kmax, 1)
    v = jax.lax.conv_general_dilated(
        x, rhs_v, window_strides=(1, 1),
        padding=((w, w), (0, 0)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)  # (1, S, H, W)
    # horizontal pass: depthwise over the S channels
    rhs_h = jnp.asarray(kmat)[:, None, None, :]   # (S, 1, 1, kmax)
    h = jax.lax.conv_general_dilated(
        v, rhs_h, window_strides=(1, 1),
        padding=((0, 0), (w, w)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=s,
        precision=jax.lax.Precision.HIGHEST)      # (1, S, H, W)
    return h[0]


def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Single-sigma blur: (H, W) -> (H, W)."""
    return gaussian_blur_multi(img, (sigma,))[0]
