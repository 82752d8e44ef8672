"""Matcher tests: the XLA top-2 L1 matcher vs the NumPy oracle
(BFMatcher NORM_L1 knnMatch k=2 + ratio 0.86, src/main.cpp:25-40).

`knn2_l1_xla` maps over query tiles when the tile divides N and runs
one chunk otherwise; both paths are checked ("xla" and
"xla_one_chunk").
"""

import numpy as np
import numpy.random as _np_rng_mod
import pytest
import jax.numpy as jnp

from sift_tpu.oracle import cpu_sift as oracle
from sift_tpu.ops import match as m

TILINGS = pytest.mark.parametrize("tiled", [True, False],
                                  ids=["xla", "xla_one_chunk"])


@pytest.fixture(scope="module")
def rng():
    """Module-local deterministic rng: the session-wide rng made test
    outcomes depend on which other modules ran first."""
    return _np_rng_mod.default_rng(0)


def _mkdesc(rng, n):
    """Synthetic sqrt-L1-normalized descriptor-like vectors."""
    d = rng.random((n, 128)).astype(np.float32) ** 2
    d /= d.sum(axis=1, keepdims=True)
    return np.sqrt(d)


@pytest.fixture(scope="module")
def descs(rng):
    return _mkdesc(rng, 300), _mkdesc(rng, 450)


def _oracle_knn2(q, t):
    d = np.abs(q[:, None, :] - t[None, :, :]).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    i1 = order[:, 0]
    return i1, d[np.arange(len(q)), i1], d[np.arange(len(q)), order[:, 1]]


def _knn2(tiled, q, t, t_valid=None):
    tile = 4 if tiled else len(q) + 1      # 4 divides every N used here
    return m.knn2_l1_xla(q, t, t_valid, tile=tile)


@TILINGS
def test_knn2_matches_oracle(descs, tiled):
    q, t = descs
    r = _knn2(tiled, q, t)
    i1, d1, d2 = _oracle_knn2(q, t)
    np.testing.assert_array_equal(np.asarray(r.idx), i1)
    np.testing.assert_allclose(np.asarray(r.d1), d1, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(r.d2), d2, rtol=2e-5, atol=2e-5)


@TILINGS
def test_train_validity_mask(descs, tiled):
    q, t = descs
    t_valid = np.ones(len(t), bool)
    t_valid[::3] = False  # knock out a third of the train rows
    r = _knn2(tiled, q, t, jnp.asarray(t_valid))
    i1, d1, _ = _oracle_knn2(q, t[t_valid])
    # map oracle indices back into the unmasked index space
    remap = np.where(t_valid)[0]
    np.testing.assert_array_equal(np.asarray(r.idx), remap[i1])
    np.testing.assert_allclose(np.asarray(r.d1), d1, rtol=2e-5, atol=2e-5)


# the per-pair shape (1536 x 1536) and a map-scale aspect (4096 x
# 131072), scaled down; a query count the tile does not divide; a
# single query row
@pytest.mark.parametrize("n,m_", [(192, 192), (64, 2048), (70, 333),
                                  (1, 5)])
def test_knn2_shapes(rng, n, m_):
    q, t = _mkdesc(rng, n), _mkdesc(rng, m_)
    r = m.knn2_l1_xla(q, t, tile=64)
    assert r.idx.shape == r.d1.shape == r.d2.shape == (n,)
    assert r.idx.dtype == jnp.int32
    i1, d1, d2 = _oracle_knn2(q, t)
    np.testing.assert_array_equal(np.asarray(r.idx), i1)
    np.testing.assert_allclose(np.asarray(r.d1), d1, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(r.d2), d2, rtol=2e-5, atol=2e-5)


@TILINGS
def test_ties_take_lowest_train_index(rng, tiled):
    """Duplicate train rows, near and far apart: the lowest index wins
    (BFMatcher's stable order) and d2 == d1."""
    q = _mkdesc(rng, 64)
    t = _mkdesc(rng, 96)
    t[5] = t[40] = t[77] = q[3]
    t[9] = t[10] = q[7]
    r = _knn2(tiled, q, t)
    idx, d1, d2 = (np.asarray(a) for a in r)
    assert idx[3] == 5 and idx[7] == 9
    assert d1[3] == d2[3] == 0.0 and d1[7] == d2[7] == 0.0


@TILINGS
def test_sentinel_rows_never_match(rng, tiled):
    """With one valid train row, d2 is a sentinel distance and the
    ratio test must reject every query (BFMatcher k=2 finds no pair)."""
    q, t = _mkdesc(rng, 64), _mkdesc(rng, 40)
    t_valid = np.zeros(40, bool)
    t_valid[17] = True
    r = _knn2(tiled, q, t, jnp.asarray(t_valid))
    assert (np.asarray(r.idx) == 17).all()
    assert (np.asarray(r.d2) >= m._SENTINEL).all()
    res = m.match_ratio(q, t, t_valid=jnp.asarray(t_valid))
    assert not np.asarray(res.good).any()


def test_mask_train_overwrites_invalid_rows():
    t = jnp.ones((4, 128))
    out = np.asarray(m.mask_train(t, jnp.array([True, False, True, False])))
    assert (out[[0, 2]] == 1.0).all() and (out[[1, 3]] == m._SENTINEL).all()
    assert m.mask_train(t, None) is t


def test_match_ratio_vs_oracle(descs):
    q, t = descs
    res = m.match_ratio(q, t, ratio=0.86)
    good = np.asarray(res.good)
    tidx = np.asarray(res.train_idx)
    ref = oracle.match_l1_ratio(q, t, ratio=0.86)
    ref_pairs = {(qi, ti) for qi, ti, _ in ref}
    got_pairs = {(int(i), int(tidx[i])) for i in np.where(good)[0]}
    assert got_pairs == ref_pairs


def test_match_ratio_respects_query_mask(descs):
    q, t = descs
    q_valid = np.zeros(len(q), bool)
    q_valid[:10] = True
    res = m.match_ratio(q, t, q_valid=np.asarray(q_valid))
    assert not np.asarray(res.good)[10:].any()


@pytest.mark.slow
def test_end_to_end_match_recall(small_image):
    """Detect+describe+match on a shifted crop pair; compare the good
    match set to the oracle pipeline's (BASELINE.json config-1 style)."""
    from sift_tpu import sift as jsift
    from sift_tpu.config import DEFAULT_CONFIG as CFG

    scene = small_image
    obj = small_image[24:120, 40:168]

    kps, ds = jsift.detect_and_compute(np.asarray(scene), CFG)
    kpo, do = jsift.detect_and_compute(np.asarray(obj), CFG)
    res = m.match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid)

    ks_ref, ds_ref = oracle.sift_ncl(scene, CFG)
    ko_ref, do_ref = oracle.sift_ncl(obj, CFG)
    ref = oracle.match_l1_ratio(do_ref, ds_ref, ratio=0.86)
    assert len(ref) >= 10

    # count oracle matches reproduced by the pipeline (by geometry:
    # both endpoints within 0.5 px of an oracle good match)
    gx = np.asarray(kps.x); gy = np.asarray(kps.y)
    ox = np.asarray(kpo.x); oy = np.asarray(kpo.y)
    good = np.where(np.asarray(res.good))[0]
    got = [(ox[q], oy[q], gx[np.asarray(res.train_idx)[q]],
            gy[np.asarray(res.train_idx)[q]]) for q in good]
    hits = 0
    for qi, ti, _ in ref:
        qr, tr = ko_ref[qi], ks_ref[ti]
        for (a, b, c, d) in got:
            if (abs(a - qr["x"]) < .5 and abs(b - qr["y"]) < .5
                    and abs(c - tr["x"]) < .5 and abs(d - tr["y"]) < .5):
                hits += 1
                break
    recall = hits / len(ref)
    assert recall >= 0.9, f"match recall {recall:.3f} over {len(ref)} ref"
