"""Sharded brute-force matching over a device mesh.

Query descriptors are sharded over the mesh "data" axis, the train
side is replicated: each chip computes its query rows' top-2 L1
distances against the full train set with the single-chip kernel, and
results concatenate for free (top-2 is row-independent). For train
sets too big to replicate, `sharded_match_ratio_train_sharded` splits
the TRAIN side and merges per-shard top-2 candidates with one small
all_gather — the distance matrix itself never crosses devices.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sift_tpu.ops import match as match_mod


def sharded_match_ratio(query: jnp.ndarray, train: jnp.ndarray,
                        mesh: Mesh,
                        q_valid: Optional[jnp.ndarray] = None,
                        t_valid: Optional[jnp.ndarray] = None,
                        ratio: float = 0.86) -> match_mod.Matches:
    """Query-sharded matcher: (N, D) x (M, D), N % n_data == 0."""
    n = query.shape[0]
    if q_valid is None:
        q_valid = jnp.ones((n,), bool)
    if t_valid is None:
        t_valid = jnp.ones((train.shape[0],), bool)

    def local(q, qv, t, tv):
        return match_mod.match_ratio(q, t, q_valid=qv, t_valid=tv,
                                     ratio=ratio)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data"), P("data"), P(None), P(None)),
                   out_specs=jax.tree_util.tree_map(
                       lambda _: P("data"),
                       match_mod.Matches(jnp.zeros(1, jnp.int32),
                                         jnp.zeros(1, jnp.int32),
                                         jnp.zeros(1), jnp.zeros(1, bool))),
                   check_vma=False)
    out = jax.jit(fn)(query, q_valid, train, t_valid)
    # query_idx restarts per shard; rebuild the global index
    return match_mod.Matches(jnp.arange(n, dtype=jnp.int32),
                             out.train_idx, out.distance, out.good)


def sharded_match_ratio_train_sharded(
        query: jnp.ndarray, train: jnp.ndarray, mesh: Mesh,
        q_valid: Optional[jnp.ndarray] = None,
        t_valid: Optional[jnp.ndarray] = None,
        ratio: float = 0.86) -> match_mod.Matches:
    """Train-sharded matcher for train sets too large to replicate.

    Each chip holds a train shard (replicated queries), computes local
    top-2, then the (d1, d2, idx) triples — 12 bytes/query, not the
    N x M distance matrix — are all_gathered and merged.
    """
    n = query.shape[0]
    m = train.shape[0]
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    shard_m = m // n_shards
    if q_valid is None:
        q_valid = jnp.ones((n,), bool)
    if t_valid is None:
        t_valid = jnp.ones((m,), bool)

    def local(q, t, tv):
        r = match_mod.knn2_l1_xla(q, t, t_valid=tv)
        base = jax.lax.axis_index(axis) * shard_m
        # (n_shards, N) candidates after gather
        d1 = jax.lax.all_gather(r.d1, axis)
        d2 = jax.lax.all_gather(r.d2, axis)
        i1 = jax.lax.all_gather(r.idx + base, axis)
        # merge per-shard top-2 into global top-2 (shards in index
        # order -> stable tie-breaking matches the single-chip kernel)
        def merge(carry, x):
            bd1, bd2, bi1 = carry
            sd1, sd2, si1 = x
            take = sd1 < bd1
            nd1 = jnp.where(take, sd1, bd1)
            ni1 = jnp.where(take, si1, bi1)
            nd2 = jnp.where(take, jnp.minimum(bd1, sd2),
                            jnp.minimum(bd2, sd1))
            return (nd1, nd2, ni1), None
        init = (jnp.full((q.shape[0],), jnp.inf), jnp.full(
            (q.shape[0],), jnp.inf), jnp.zeros((q.shape[0],), jnp.int32))
        (d1g, d2g, i1g), _ = jax.lax.scan(merge, init, (d1, d2, i1))
        return match_mod.Knn2(i1g, d1g, d2g)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(None), P(axis), P(axis)),
                   out_specs=jax.tree_util.tree_map(
                       lambda _: P(None),
                       match_mod.Knn2(jnp.zeros(1, jnp.int32),
                                      jnp.zeros(1), jnp.zeros(1))),
                   check_vma=False)
    r = jax.jit(fn)(query, train, t_valid)
    good = (r.d1 <= ratio * r.d2) & (r.d1 < match_mod._SENTINEL) & q_valid
    return match_mod.Matches(jnp.arange(n, dtype=jnp.int32),
                             r.idx, r.d1, good)
