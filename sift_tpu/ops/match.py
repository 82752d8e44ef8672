"""Brute-force kNN descriptor matching (replaces reference C11).

Functional twin of BFMatcher(NORM_L1).knnMatch(query, train, k=2) plus
the Lowe ratio test `d1 <= ratio * d2` (reference src/main.cpp:25-40,
ratio 0.86). The reference outsources this to OpenCV; here it is our
own tiled XLA program — the pipeline's O(N*M*128) distance hot spot
(SURVEY.md §3.5).

Descriptors live in fixed-capacity padded arrays with validity masks.
Invalid train rows are pre-masked to a huge sentinel value so their
distances never win; invalid query rows are filtered after the fact.
`knn2_l1_xla` maps over query tiles and lets XLA fuse the broadcast
|q - t| sums; top_k then picks the best two per row. Tie-breaking
matches BFMatcher's stable ordering (lowest train index wins equal
distances).

A fused Pallas kernel on the Triton route (train tiles looped inside
each query block, running top-2 in registers, no N x M matrix in
memory) was measured against this on an H100 and lost at the per-pair
shape while adding minutes of compile time; see ARCHITECTURE.md.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

_SENTINEL = 1.0e6  # masked train descriptor value; L1 dist >= 1e8


class Knn2(NamedTuple):
    """Top-2 L1 match result per query row."""
    idx: jnp.ndarray   # (N,) int32, best train index
    d1: jnp.ndarray    # (N,) float32, best distance
    d2: jnp.ndarray    # (N,) float32, second-best distance


def mask_train(train: jnp.ndarray, t_valid: Optional[jnp.ndarray]
               ) -> jnp.ndarray:
    """Overwrite invalid train rows with a sentinel so they never match."""
    if t_valid is None:
        return train
    return jnp.where(t_valid[:, None], train,
                     jnp.full_like(train, _SENTINEL))


@functools.partial(jax.jit, static_argnames=("tile",))
def knn2_l1_xla(query: jnp.ndarray, train: jnp.ndarray,
                t_valid: Optional[jnp.ndarray] = None,
                tile: int = 256) -> Knn2:
    """Pure-XLA top-2 L1 matcher: (N, D) x (M, D) -> Knn2.

    N must be a multiple of `tile` (descriptor batches are padded to
    power-of-two capacities upstream).
    """
    n, d = query.shape
    t = mask_train(train.astype(jnp.float32), t_valid)
    if n % tile != 0:
        tile = n  # fall back to one chunk
    nq = n // tile

    def chunk(q):
        # (tile, M) distances; XLA fuses the broadcast+abs+reduce
        dist = jnp.sum(jnp.abs(q[:, None, :] - t[None, :, :]), axis=-1)
        # top-2 smallest; negate for top_k (stable: lowest index on ties)
        neg, idx = jax.lax.top_k(-dist, 2)
        return idx[:, 0].astype(jnp.int32), -neg[:, 0], -neg[:, 1]

    i1, d1, d2 = jax.lax.map(chunk, query.astype(jnp.float32)
                             .reshape(nq, tile, d))
    return Knn2(i1.reshape(n), d1.reshape(n), d2.reshape(n))


class Matches(NamedTuple):
    """Ratio-test-filtered matches, padded to query capacity.

    good[i] is True iff query i is valid, its best train match is
    valid, and d1 <= ratio * d2 (reference src/main.cpp:38).
    """
    query_idx: jnp.ndarray  # (N,) int32 (= arange)
    train_idx: jnp.ndarray  # (N,) int32
    distance: jnp.ndarray   # (N,) float32
    good: jnp.ndarray       # (N,) bool


@functools.partial(jax.jit, static_argnames=("ratio",))
def match_ratio(query: jnp.ndarray, train: jnp.ndarray,
                q_valid: Optional[jnp.ndarray] = None,
                t_valid: Optional[jnp.ndarray] = None,
                ratio: float = 0.86) -> Matches:
    """knnMatch(k=2) + Lowe ratio test (src/main.cpp:25-40)."""
    r = knn2_l1_xla(query, train, t_valid)
    good = r.d1 <= ratio * r.d2
    # a query whose best hit is the sentinel row matched nothing real;
    # and with <2 valid train rows d2 is the sentinel, so the ratio
    # test would pass vacuously — BFMatcher k=2 finds no pair either
    good = good & (r.d1 < _SENTINEL) & (r.d2 < _SENTINEL)
    if q_valid is not None:
        good = good & q_valid
    n = query.shape[0]
    return Matches(jnp.arange(n, dtype=jnp.int32), r.idx, r.d1, good)
