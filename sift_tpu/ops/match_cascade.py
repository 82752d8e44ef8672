"""Two-stage cascade matcher for map-scale descriptor sets.

The exact matcher (ops/match.py) is O(N*M*128) — fine for frame pairs
(~2k x 2k), quadratic death for map-scale retrieval (config 5:
matching a frame against a 100k+ point map, or loop-closure search
over all keyframes). The classic CPU answer is cascade hashing;
hash-bucketing is scatter-heavy, so this is the dense-product
equivalent:

  stage 1 (coarse, matrix products): project both sides to a low dimension with a
      fixed seeded random matrix (a GEMM), compute squared-L2
      distances as another GEMM (||a-b||^2 = |a|^2 + |b|^2 - 2ab),
      and take the top-C candidate train rows per query. Cost is
      O(N*M*d') with d'=16 — 8x fewer multiplies than exact, all on
      matrix products instead of elementwise L1 work.
  stage 2 (exact, gathered): gather the C candidates' full
      descriptors and run the EXACT L1 top-2 + ratio test among them
      (reference semantics, src/main.cpp:25-40). O(N*C*128).

Validation at the advertised scale (bench_cascade.py on the CPU,
corpus descriptors + jittered twins among corpus-derived distractors,
round 3 measured):

  ratio-DECISION agreement vs the exact matcher, queries whose true
  match IS in the train set (201 matched of ~400 queries):

      M rows | C=32  C=64  C=128  C=256
      8192   | 1.0   1.0   1.0    1.0
      32768  | 1.0   1.0   1.0    1.0
      131072 | 1.0   1.0   1.0    1.0    (recall of exact-good = 1.0)

  the real failure mode is HALLUCINATION on queries with NO true
  match (a truncated candidate set can shrink d2 and pass the ratio
  test spuriously), per 130 match-free queries:

      M rows | C=32  C=64  C=128  C=256
      8192   | 0     2     1      1
      32768  | 4     0     0      1
      131072 | 6     3     1      1

Rule: the default C=64 holds decision agreement 1.0 through 131k rows
with ~1-2% hallucination on match-free queries — fine wherever
matches feed geometric verification (loop closure, RANSAC). Raise to
C=128 if raw match decisions are consumed unverified. Survival of the
true top-2 in the coarse top-C is governed by the JL distance
distortion of the d'=16 projection, which is independent of M — the
measured flat trend across 8k->131k confirms it; C needs to grow only
if the DENSITY of near-duplicates grows (e.g. many revisits of the
same structure), not with map size per se.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from sift_tpu.ops.match import Matches, Knn2, mask_train, _SENTINEL


def _projection(d: int, d_proj: int, seed: int) -> jnp.ndarray:
    """Fixed Gaussian random projection (seeded, compile-time const)."""
    key = jax.random.PRNGKey(seed)
    return jax.random.normal(key, (d, d_proj), jnp.float32) / (d ** 0.5)


@functools.partial(jax.jit,
                   static_argnames=("n_candidates", "d_proj", "ratio",
                                    "seed", "tile",
                                    "downstream_verified"))
def match_ratio_cascade(query: jnp.ndarray, train: jnp.ndarray,
                        q_valid: Optional[jnp.ndarray] = None,
                        t_valid: Optional[jnp.ndarray] = None,
                        ratio: float = 0.86,
                        n_candidates: int = 64,
                        d_proj: int = 16,
                        seed: int = 7,
                        tile: int = 512,
                        downstream_verified: bool = True) -> Matches:
    """Cascade kNN + Lowe ratio test: (N, D) x (M, D) -> Matches.

    Matches the exact matcher's semantics wherever the true top-2
    train rows land in the coarse top-C (measured >=99.9% of
    decisions on corpus pairs at C=64).

    downstream_verified: keep the default True ONLY when the matches
    feed geometric verification (RANSAC/essential), which absorbs the
    measured ~1-2% hallucination rate on match-free queries (CASCADE
    .json). Pass False when raw decisions are consumed directly —
    the candidate depth is then raised to >=128, the depth at which
    hallucinations measured <=1 per 130 match-free queries through
    131k rows. This makes the docstring rule enforceable instead of
    advisory.
    """
    if not downstream_verified:
        n_candidates = max(n_candidates, 128)
    n, d = query.shape
    m = train.shape[0]
    if n == 0:
        # empty query frame: the tiling below would divide by
        # tile_n == 0 at trace time; nothing to match
        return Matches(jnp.zeros((0,), jnp.int32),
                       jnp.zeros((0,), jnp.int32),
                       jnp.zeros((0,), jnp.float32),
                       jnp.zeros((0,), bool))
    if m < 2:
        # BFMatcher k=2 semantics need two train rows; nothing can be
        # a good match (and lax.top_k(k=2) would reject m==1)
        return Matches(jnp.arange(n, dtype=jnp.int32),
                       jnp.zeros((n,), jnp.int32),
                       jnp.full((n,), _SENTINEL, jnp.float32),
                       jnp.zeros((n,), bool))
    c = min(n_candidates, m)
    proj = _projection(d, d_proj, seed)
    q32 = query.astype(jnp.float32)
    t32 = mask_train(train.astype(jnp.float32), t_valid)

    qp = q32 @ proj                                   # (N, d')
    tp = t32 @ proj                                   # (M, d')
    t_sq = jnp.sum(tp * tp, axis=1)                   # (M,)

    # pad the query side up to a tile multiple: falling back to one
    # giant chunk would materialize the full (N, M) coarse matrix —
    # exactly what the tiling exists to avoid at map scale
    tile_n = min(tile, n)
    pad_n = (-n) % tile_n
    if pad_n:
        q32 = jnp.pad(q32, ((0, pad_n), (0, 0)))
        qp = jnp.pad(qp, ((0, pad_n), (0, 0)))
    nq = (n + pad_n) // tile_n

    def chunk(args):
        qp_c, q_c = args
        # coarse squared-L2 via GEMM; the -2ab term dominates cost
        coarse = (t_sq[None, :]
                  - 2.0 * (qp_c @ tp.T))              # (tile, M) + |q|^2
        _, cand = jax.lax.top_k(-coarse, c)           # (tile, C)
        tc = t32[cand]                                # (tile, C, D)
        dist = jnp.sum(jnp.abs(q_c[:, None, :] - tc), axis=-1)
        neg, idx2 = jax.lax.top_k(-dist, 2)
        best = jnp.take_along_axis(cand, idx2[:, :1], axis=1)[:, 0]
        return best.astype(jnp.int32), -neg[:, 0], -neg[:, 1]

    i1, d1, d2 = jax.lax.map(
        chunk, (qp.reshape(nq, tile_n, d_proj),
                q32.reshape(nq, tile_n, d)))
    r = Knn2(i1.reshape(-1)[:n], d1.reshape(-1)[:n],
             d2.reshape(-1)[:n])

    good = r.d1 <= ratio * r.d2
    good = good & (r.d1 < _SENTINEL) & (r.d2 < _SENTINEL)
    if q_valid is not None:
        good = good & q_valid
    return Matches(jnp.arange(n, dtype=jnp.int32), r.idx, r.d1, good)
