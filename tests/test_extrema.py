"""Exact two-stage top-k candidate selection (ops/extrema.py)."""

import numpy as np
import numpy.random as _np_rng_mod
import pytest
import jax.numpy as jnp

from sift_tpu.ops import extrema as ext


@pytest.fixture(scope="module")
def rng():
    """Module-local deterministic rng: the session-wide rng made test
    outcomes depend on which other modules ran first."""
    return _np_rng_mod.default_rng(0)


def test_two_stage_topk_exact(rng):
    score = np.full(300_000, -1.0, np.float32)
    hot = rng.choice(300_000, 900, replace=False)
    score[hot] = rng.uniform(8, 200, 900).astype(np.float32)
    v, i = ext._top_k_two_stage(jnp.asarray(score), 1024)
    got = set(np.asarray(i)[np.asarray(v) > 0].tolist())
    assert got == set(hot.tolist())


def test_two_stage_topk_batch_exact(rng):
    score = np.full((2, 300_000), -1.0, np.float32)
    hots = []
    for b in range(2):
        hot = rng.choice(300_000, 700 + 200 * b, replace=False)
        score[b, hot] = rng.uniform(8, 200, len(hot)).astype(np.float32)
        hots.append(set(hot.tolist()))
    v, i = ext._top_k_two_stage_batch(jnp.asarray(score), 1024)
    for b in range(2):
        got = set(np.asarray(i[b])[np.asarray(v[b]) > 0].tolist())
        assert got == hots[b]
