"""Aux subsystem tests: checkpointing, health/restart, logging,
profiling."""

import numpy as np
import numpy.random as _np_rng_mod
import jax
import jax.numpy as jnp
import pytest

from sift_tpu.sfm.ba import BAProblem, reproj_rmse
from sift_tpu.sfm import checkpoint as ckpt
from sift_tpu.utils import health
from sift_tpu.utils.logger import COUNTERS, configure, get_logger
from sift_tpu.utils.profiling import StageTimer


def _tiny_problem(rng):
    n_cams, n_pts, n_obs = 3, 16, 64
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
    cams = np.zeros((n_cams, 6), np.float32)
    cams[:, 3] = np.linspace(-0.3, 0.3, n_cams)
    ci = rng.integers(0, n_cams, n_obs).astype(np.int32)
    pi = rng.integers(0, n_pts, n_obs).astype(np.int32)
    xc = pts[pi] + cams[ci][:, 3:]
    uv = (xc[:, :2] / xc[:, 2:3]).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return BAProblem(jnp.asarray(cams), jnp.asarray(pts),
                     jnp.asarray(ci), jnp.asarray(pi), jnp.asarray(uv),
                     jnp.ones(n_obs, bool), jnp.asarray(fixed))


@pytest.mark.slow
def test_checkpoint_roundtrip(rng, tmp_path):
    prob = _tiny_problem(rng)
    path = ckpt.save_ba(str(tmp_path / "ba_7"), prob, step=7)
    prob2, step = ckpt.load_ba(path)
    assert step == 7
    for f in prob._fields:
        np.testing.assert_array_equal(np.asarray(getattr(prob, f)),
                                      np.asarray(getattr(prob2, f)))


def test_checkpoint_latest(rng, tmp_path):
    prob = _tiny_problem(rng)
    ckpt.save_ba(str(tmp_path / "ba_1"), prob, step=1)
    p2 = ckpt.save_ba(str(tmp_path / "ba_12"), prob, step=12)
    assert ckpt.latest(str(tmp_path)) == p2


def test_restartable_ba_improves(rng):
    prob = _tiny_problem(rng)
    # perturb cameras so BA has work to do
    cams = np.asarray(prob.cameras).copy()
    cams[1:] += 0.01
    prob = prob._replace(cameras=jnp.asarray(cams))
    out, restarts = health.bundle_adjust_restartable(prob, iters=8)
    assert restarts == 0
    assert float(np.asarray(reproj_rmse(out))) <= \
        float(np.asarray(reproj_rmse(prob)))


def test_finiteness_guard():
    assert health.tree_all_finite({"a": jnp.ones(3)})
    assert not health.tree_all_finite({"a": jnp.array([1.0, np.nan])})
    with pytest.raises(FloatingPointError):
        health.assert_finite(jnp.array([np.inf]), "x")


def test_mesh_health():
    from sift_tpu.parallel import default_mesh
    assert health.mesh_health_check(default_mesh(8))


def test_counters_and_logger():
    configure("INFO")
    COUNTERS.reset()
    COUNTERS.inc("kpts", 5)
    COUNTERS.inc("kpts", 2)
    COUNTERS.set("frames", 3)
    snap = COUNTERS.snapshot()
    assert snap == {"kpts": 7.0, "frames": 3.0}
    get_logger("test").info("logger alive")


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        x = jnp.ones((8, 8)) * 2
        t.sink(x)
    assert "a" in t.summary()
    assert t.report()


import pytest as _pytest


@_pytest.fixture(scope="module")
def rng():
    """Module-local deterministic rng: the session-wide rng made test
    outcomes depend on which other modules ran first."""
    return _np_rng_mod.default_rng(0)

