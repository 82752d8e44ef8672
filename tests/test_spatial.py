"""Spatial tiling: one frame row-sharded over the mesh must reproduce
the single-device detect+describe exactly (SURVEY §5 long-context
analog; the reference instead resizes the scene to 960x960,
src/main.cpp:83).

Capacity semantics differ (per-device caps on tiled octaves), so
parity compares the SET of valid keypoints. The fixture stays far
below the caps so no compaction ambiguity exists.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sift_tpu import sift
from sift_tpu.config import SIFTConfig
from sift_tpu.parallel import default_mesh
from sift_tpu.parallel.spatial import detect_and_compute_tiled

CFG = SIFTConfig(detect_caps=(256, 128, 64, 32, 16),
                 out_caps=(128, 64, 32, 16, 8), max_keypoints=248)


def _valid_set(kp, d):
    v = np.asarray(kp.valid)
    xy = np.stack([np.asarray(kp.x)[v], np.asarray(kp.y)[v],
                   np.asarray(kp.angle)[v], np.asarray(kp.size)[v]], 1)
    dd = np.asarray(d)[v]
    order = np.lexsort((xy[:, 2], xy[:, 1], xy[:, 0]))
    return xy[order], dd[order]


@pytest.mark.slow
def test_tiled_matches_single_device(scene_gray_small):
    img = jnp.asarray(scene_gray_small)
    mesh = default_mesh(2)
    kp_t, d_t = detect_and_compute_tiled(img, mesh, CFG,
                                         tiled_octaves=1)
    kp_s, d_s = sift.detect_and_compute(img, CFG)
    xt, dt = _valid_set(kp_t, d_t)
    xs, ds = _valid_set(kp_s, d_s)
    assert len(xs) > 30, "degenerate fixture"
    assert len(xt) == len(xs), (len(xt), len(xs))
    np.testing.assert_allclose(xt, xs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(dt, ds, rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def scene_gray_small():
    from sift_tpu import synth
    return synth.procedural_texture(256, 320, seed=3)


@pytest.mark.slow
def test_tiled_two_octaves_matches_single_device(scene_gray_small):
    """tiled_octaves=2 exercises the tiled->tiled decimation handoff
    (band halving + next-octave halo exchange) that tiled_octaves=1
    never runs; must still be exact."""
    img = jnp.asarray(scene_gray_small)
    mesh = default_mesh(2)
    kp_t, d_t = detect_and_compute_tiled(img, mesh, CFG,
                                         tiled_octaves=2, halo=48)
    kp_s, d_s = sift.detect_and_compute(img, CFG)
    xt, dt = _valid_set(kp_t, d_t)
    xs, ds = _valid_set(kp_s, d_s)
    assert len(xs) > 30, "degenerate fixture"
    assert len(xt) == len(xs), (len(xt), len(xs))
    np.testing.assert_allclose(xt, xs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(dt, ds, rtol=0, atol=1e-3)
