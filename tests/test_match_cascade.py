"""Cascade matcher vs the exact matcher: decision agreement on real
SIFT descriptors of a seeded textured image (the 'ratio-test
decisions unchanged' criterion) and synthetic stress cases."""

import numpy as np
import pytest
import jax.numpy as jnp

from sift_tpu.ops import match as match_mod
from sift_tpu.ops.match_cascade import match_ratio_cascade


@pytest.fixture(scope="module")
def corpus_descs(book_gray):
    from sift_tpu import sift
    kp, desc = sift.detect_and_compute(np.asarray(book_gray))
    valid = np.asarray(kp.valid)
    return np.asarray(desc), valid


def test_cascade_agrees_with_exact_on_corpus(corpus_descs):
    desc, valid = corpus_descs
    assert valid.sum() > 50
    # match the image's descriptors against a perturbed copy of
    # themselves: realistic distance structure, nontrivial ratios
    rng = np.random.default_rng(0)
    train = np.sqrt(np.maximum(
        desc ** 2 + rng.normal(0, 5e-4, desc.shape), 0.0)
    ).astype(np.float32)
    exact = match_mod.match_ratio(
        jnp.asarray(desc), jnp.asarray(train),
        q_valid=jnp.asarray(valid), t_valid=jnp.asarray(valid))
    casc = match_ratio_cascade(
        jnp.asarray(desc), jnp.asarray(train),
        q_valid=jnp.asarray(valid), t_valid=jnp.asarray(valid))
    ge, gc = np.asarray(exact.good), np.asarray(casc.good)
    te, tc = np.asarray(exact.train_idx), np.asarray(casc.train_idx)
    agree = (ge == gc) & (~ge | (te == tc))
    assert agree.mean() >= 0.999, agree.mean()
    assert ge.sum() > 20   # the comparison is non-vacuous


def test_cascade_empty_query():
    """n==0 queries must not crash the tiling (ZeroDivisionError at
    trace time, round-2 advisor finding)."""
    rng = np.random.default_rng(3)
    t = np.abs(rng.random((64, 128)).astype(np.float32))
    out = match_ratio_cascade(jnp.zeros((0, 128), jnp.float32),
                              jnp.asarray(t))
    assert out.good.shape == (0,)
    assert out.train_idx.shape == (0,)


def test_cascade_respects_masks():
    rng = np.random.default_rng(1)

    def mk(n):
        d = rng.random((n, 128)).astype(np.float32) ** 2
        d /= d.sum(axis=1, keepdims=True)
        return np.sqrt(d)

    q, t = mk(256), mk(1024)
    t_valid = np.ones(1024, bool)
    t_valid[::3] = False
    out = match_ratio_cascade(jnp.asarray(q), jnp.asarray(t),
                              t_valid=jnp.asarray(t_valid))
    good = np.asarray(out.good)
    ti = np.asarray(out.train_idx)
    assert t_valid[ti[good]].all()


def test_cascade_scales_to_map_sized_train():
    """Map-scale shape check: 1k queries vs 32k train rows."""
    rng = np.random.default_rng(2)

    def mk(n):
        d = rng.random((n, 128)).astype(np.float32) ** 2
        d /= d.sum(axis=1, keepdims=True)
        return np.sqrt(d)

    q = mk(1024)
    t = np.concatenate([q + rng.normal(0, 1e-3, q.shape)
                        .astype(np.float32), mk(31 * 1024)])
    out = match_ratio_cascade(jnp.asarray(q), jnp.asarray(np.abs(t)))
    ti = np.asarray(out.train_idx)
    # each query's true nearest neighbor is its perturbed twin at the
    # same index; the cascade must find essentially all of them
    assert (ti == np.arange(1024)).mean() > 0.99


@pytest.mark.slow
def test_cascade_at_advertised_100k_scale():
    """The module advertises 100k+ point maps: at 131072 train rows
    with the default n_candidates the cascade must still route every
    query to its true twin (bench_cascade.py prints the full
    agreement sweep vs the exact matcher)."""
    rng = np.random.default_rng(5)

    def mk(n):
        d = rng.random((n, 128)).astype(np.float32) ** 2
        d /= d.sum(axis=1, keepdims=True)
        return np.sqrt(d)

    q = mk(1024)
    t = np.concatenate([q + rng.normal(0, 1e-3, q.shape)
                        .astype(np.float32), mk(127 * 1024)])
    out = match_ratio_cascade(jnp.asarray(q), jnp.asarray(np.abs(t)))
    ti = np.asarray(out.train_idx)
    assert (ti == np.arange(1024)).mean() > 0.99
