"""Gaussian + DoG scale-space pyramids (replaces reference C6/C7).

Functional twin of buildGaussianPyramid / buildDoGPyramid
(src/sift.cpp:229-283), restructured for XLA: each octave is one
(n_scales, H_o, W_o) array, its non-base layers produced by a single
batched separable convolution of the octave base (legal because the
reference blurs every layer directly from the base with
sig[i] = sqrt((k^i s)^2 - s^2), src/sift.cpp:241-258).

Octave chaining matches the reference: next base = layer
`n_octave_layers` of the previous octave, 2x nearest-neighbor
decimated (src/sift.cpp:252-254); no initial upsampling
(src/sift.cpp:219-227).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.ops.conv import gaussian_blur_multi, gaussian_blur_multi_batch
from sift_tpu.ops.image import downsample_nearest_2x


def build_gaussian_pyramid(img: jnp.ndarray,
                           cfg: SIFTConfig = DEFAULT_CONFIG
                           ) -> List[jnp.ndarray]:
    """Returns n_octaves arrays of shape (n_scales, H_o, W_o)."""
    sig = cfg.scale_sigmas()
    base = gaussian_blur_multi(img.astype(jnp.float32),
                               (cfg.init_blur_sigma,))[0]
    octaves: List[jnp.ndarray] = []
    for o in range(cfg.n_octaves):
        if o > 0:
            base = downsample_nearest_2x(octaves[o - 1][cfg.n_octave_layers])
        layers = gaussian_blur_multi(base, sig[1:])          # (S-1, H, W)
        octaves.append(jnp.concatenate([base[None], layers], axis=0))
    return octaves


def build_gaussian_pyramid_batch(imgs: jnp.ndarray,
                                 cfg: SIFTConfig = DEFAULT_CONFIG
                                 ) -> List[jnp.ndarray]:
    """Batched frames: (B, H, W) -> n_octaves arrays (B, S, H_o, W_o).

    Per-frame output is identical to build_gaussian_pyramid; the batch
    rides one conv axis so small octaves still fill the device
    (single-device throughput path)."""
    sig = cfg.scale_sigmas()
    base = gaussian_blur_multi_batch(imgs.astype(jnp.float32),
                                     (cfg.init_blur_sigma,))[:, 0]
    octaves: List[jnp.ndarray] = []
    for o in range(cfg.n_octaves):
        if o > 0:
            prev = octaves[o - 1][:, cfg.n_octave_layers]   # (B, H, W)
            h2, w2 = prev.shape[1] // 2, prev.shape[2] // 2
            x = prev[:, :2 * h2, :2 * w2]
            base = x.reshape(x.shape[0], h2, 2, w2, 2)[:, :, 0, :, 0]
        layers = gaussian_blur_multi_batch(base, sig[1:])   # (B, S-1, H, W)
        octaves.append(jnp.concatenate([base[:, None], layers], axis=1))
    return octaves


def build_dog_pyramid(octaves: List[jnp.ndarray]) -> List[jnp.ndarray]:
    """dog[i] = gauss[i+1] - gauss[i] per octave (src/sift.cpp:271-281).

    Returns n_octaves arrays of shape (n_scales - 1, H_o, W_o).
    """
    return [oct[1:] - oct[:-1] for oct in octaves]


def build_dog_pyramid_batch(octaves: List[jnp.ndarray]
                            ) -> List[jnp.ndarray]:
    """Batched: n_octaves arrays (B, S, H, W) -> (B, S-1, H, W)."""
    return [oct[:, 1:] - oct[:, :-1] for oct in octaves]
