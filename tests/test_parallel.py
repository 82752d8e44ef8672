"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import numpy.random as _np_rng_mod
import pytest
import jax
import jax.numpy as jnp

from sift_tpu.config import DEFAULT_CONFIG as CFG
from sift_tpu import sift
from sift_tpu.parallel import (make_mesh, default_mesh,
                               batched_detect_and_compute,
                               sharded_match_ratio)
from sift_tpu.parallel.match import sharded_match_ratio_train_sharded
from sift_tpu.ops import match as match_mod


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"
    return default_mesh(8)


@pytest.fixture(scope="module")
def frame_batch(small_image):
    """8 shifted crops of the synthetic image."""
    crops = [small_image[i:i + 120, i:i + 160] for i in range(8)]
    return np.stack(crops).astype(np.float32)


@pytest.mark.slow
def test_batched_detect_matches_single(frame_batch, mesh8):
    kp, desc = batched_detect_and_compute(jnp.asarray(frame_batch), mesh8)
    assert desc.shape[0] == 8
    kp1, d1 = sift.detect_and_compute(jnp.asarray(frame_batch[3]), CFG)
    np.testing.assert_allclose(np.asarray(desc[3]), np.asarray(d1),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(kp.valid[3]),
                                  np.asarray(kp1.valid))
    np.testing.assert_allclose(np.asarray(kp.x[3]), np.asarray(kp1.x),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.slow
def test_batched_detect_scan_mode_matches_single(frame_batch, mesh8):
    """frames_per_chip_mode="scan" (per-frame latency graph under
    lax.map) must produce exactly the same per-frame results as the
    single-frame facade."""
    import dataclasses
    cfg = dataclasses.replace(CFG, frames_per_chip_mode="scan")
    kp, desc = batched_detect_and_compute(jnp.asarray(frame_batch),
                                          mesh8, cfg)
    kp1, d1 = sift.detect_and_compute(jnp.asarray(frame_batch[5]), CFG)
    np.testing.assert_allclose(np.asarray(desc[5]), np.asarray(d1),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(kp.valid[5]),
                                  np.asarray(kp1.valid))
    np.testing.assert_allclose(np.asarray(kp.x[5]), np.asarray(kp1.x),
                               rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def descs(rng):
    def make(n):
        d = rng.random((n, 128)).astype(np.float32) ** 2
        d /= d.sum(axis=1, keepdims=True)
        return np.sqrt(d)
    return make(256), make(512)


def test_query_sharded_match(descs, mesh8):
    q, t = descs
    ref = match_mod.match_ratio(q, t)
    out = sharded_match_ratio(jnp.asarray(q), jnp.asarray(t), mesh8)
    np.testing.assert_array_equal(np.asarray(out.good), np.asarray(ref.good))
    np.testing.assert_array_equal(np.asarray(out.train_idx),
                                  np.asarray(ref.train_idx))


def test_train_sharded_match(descs, mesh8):
    q, t = descs
    ref = match_mod.match_ratio(q, t)
    out = sharded_match_ratio_train_sharded(
        jnp.asarray(q), jnp.asarray(t), mesh8)
    np.testing.assert_array_equal(np.asarray(out.good), np.asarray(ref.good))
    np.testing.assert_array_equal(np.asarray(out.train_idx),
                                  np.asarray(ref.train_idx))
    np.testing.assert_allclose(np.asarray(out.distance),
                               np.asarray(ref.distance), rtol=1e-5)


def test_train_sharded_respects_masks(descs, mesh8):
    q, t = descs
    t_valid = np.ones(len(t), bool)
    t_valid[1::2] = False
    ref = match_mod.match_ratio(q, t, t_valid=t_valid)
    out = sharded_match_ratio_train_sharded(
        jnp.asarray(q), jnp.asarray(t), mesh8,
        t_valid=jnp.asarray(t_valid))
    np.testing.assert_array_equal(np.asarray(out.good), np.asarray(ref.good))
    got = np.asarray(out.train_idx)[np.asarray(out.good)]
    want = np.asarray(ref.train_idx)[np.asarray(ref.good)]
    np.testing.assert_array_equal(got, want)


def test_mesh_construction():
    m = make_mesh((4, 2))
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (4, 2)


import pytest as _pytest


@_pytest.fixture(scope="module")
def rng():
    """Module-local deterministic rng: the session-wide rng made test
    outcomes depend on which other modules ran first."""
    return _np_rng_mod.default_rng(0)
