"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device sharding tests use a virtual 8-device mesh per SURVEY.md §4.
Tests that need a GPU carry the `gpu` marker and decide inside a
fixture whether one is present (tests/test_gpu.py); they run on the card with

    SIFT_GPU_TESTS=1 python -m pytest tests/test_gpu.py -q
"""

import os

_GPU = os.environ.get("SIFT_GPU_TESTS") == "1"

if not _GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _GPU:
    # pin the CPU through the config too: it outranks a platform list
    # a site configuration may have set at interpreter start
    jax.config.update("jax_platforms", "cpu")

from sift_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# the suite compiles ~100 distinct XLA programs; caching them across
# runs cuts wall time several-fold
enable_compile_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sift_tpu import synth  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_image():
    """Deterministic synthetic test image with blob/corner structure."""
    rng = np.random.default_rng(42)
    h, w = 160, 200
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 110.0 + 35.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    # scatter gaussian blobs of varying scale/polarity
    for k in range(60):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        s = rng.uniform(1.2, 7.0)
        a = rng.uniform(50, 120) * (1 if k % 2 == 0 else -1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    # blocky texture to add corners/edges at several scales
    from scipy import ndimage
    blocks = rng.uniform(-60, 60, (h // 8, w // 8))
    img += ndimage.zoom(blocks, 8, order=0)[:h, :w]
    img += rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.fixture(scope="session")
def book_gray():
    """The demo's object role: a seeded, densely textured planar
    object image (224 x 160, the size the tests always used)."""
    return synth.object_image(224, 160, seed=1)
