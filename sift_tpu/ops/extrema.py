"""DoG scale-space extrema scan (replaces reference C8a).

Functional twin of the 26-neighbor NMS in
findScaleSpaceExtremaComputer (src/sift.cpp:487-511): a pixel is a
candidate iff |val| > 8 (the literal threshold passed at
src/sift.cpp:564) and it is >= (resp. <=) every neighbor of its
3x3x3 DoG cube, with a 5 px border margin (src/sift.cpp:487-491).

Restructured for XLA: the reference walks pixels serially and
pushes into TLS vectors; we evaluate the NMS as a dense masked
array program over the whole octave (one fused elementwise loop)
and surface the top-K candidates by |response| via top_k — fixed
capacity, validity-masked.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import jax

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG


def extrema_mask(dog: jnp.ndarray, cfg: SIFTConfig = DEFAULT_CONFIG
                 ) -> jnp.ndarray:
    """(D, H, W) DoG stack -> (nL, H, W) candidate mask for layers 1..nL."""
    nl = cfg.n_octave_layers
    d, h, w = dog.shape
    val = dog[1:1 + nl]
    p = jnp.pad(dog, ((0, 0), (1, 1), (1, 1)))
    nmax = jnp.full_like(val, -jnp.inf)
    nmin = jnp.full_like(val, jnp.inf)
    for dl in (-1, 0, 1):
        for dr in (0, 1, 2):
            for dc in (0, 1, 2):
                if dl == 0 and dr == 1 and dc == 1:
                    continue  # center
                s = jax.lax.dynamic_slice(
                    p, (1 + dl, dr, dc), (nl, h, w))
                nmax = jnp.maximum(nmax, s)
                nmin = jnp.minimum(nmin, s)
    mask = (jnp.abs(val) > cfg.nms_threshold) & (
        ((val > 0) & (val >= nmax)) | ((val < 0) & (val <= nmin)))
    b = cfg.img_border
    rr = jnp.arange(h)
    cc = jnp.arange(w)
    border = ((rr >= b) & (rr < h - b))[:, None] & (
        (cc >= b) & (cc < w - b))[None, :]
    return mask & border[None]


def _top_k_two_stage(score: jnp.ndarray, cap: int,
                     blk: int = 4096, kb: int = 128):
    """Exact top-k via (per-4096-block top-128) -> global top-cap.

    A single 4M-element top_k costs ~8 ms at 1080p (full sort); the
    two-stage form is ~3x faster and exact as long as no 4096-element
    block holds >128 candidates — NMS spacing makes that physically
    implausible for real frames (measured real-frame max is 28 per
    1920-px row), but degenerate inputs (plateaus admitted by the
    reference's >=/<= extremum test, src/sift.cpp:493-511) can
    saturate a block. A block is saturated iff its kb-th best value is
    a real candidate (> 0); in that case lax.cond falls back to the
    exact full top_k so no keypoint is ever silently dropped.
    """
    n = score.shape[0]
    if n <= 2 * blk or n <= cap:
        k = min(cap, n)
        return jax.lax.top_k(score, k)
    pad = (-n) % blk
    s = jnp.pad(score, (0, pad), constant_values=-1.0)
    rows = s.reshape(-1, blk)
    kb = min(kb, cap)
    v1, i1 = jax.lax.top_k(rows, kb)
    saturated = jnp.any(v1[:, -1] > 0.0)
    base = jnp.arange(rows.shape[0], dtype=jnp.int32)[:, None] * blk
    flat_idx = (i1 + base).reshape(-1)
    k2 = min(cap, flat_idx.shape[0])

    def fast(_):
        v2, i2 = jax.lax.top_k(v1.reshape(-1), k2)
        return v2, flat_idx[i2]

    def exact(_):
        v2, i2 = jax.lax.top_k(s, k2)
        return v2, i2.astype(jnp.int32)

    out_v, out_i = jax.lax.cond(saturated, exact, fast, operand=None)
    if k2 < cap:    # small octave: fewer stage-1 slots than the cap
        out_v = jnp.pad(out_v, (0, cap - k2), constant_values=-1.0)
        out_i = jnp.pad(out_i, (0, cap - k2))
    return out_v, out_i


def _top_k_two_stage_batch(score: jnp.ndarray, cap: int,
                           blk: int = 4096, kb: int = 128):
    """Batched (B, N) variant of _top_k_two_stage.

    The saturation fallback is decided ONCE over the whole batch (any
    frame's block saturated -> exact path for all): under vmap a
    lax.cond lowers to select and runs BOTH branches every time, which
    would always pay the full-sort cost the two-stage form exists to
    avoid — so the cond stays at batch level here.
    """
    nb, n = score.shape
    if n <= 2 * blk or n <= cap:
        return jax.lax.top_k(score, min(cap, n))
    pad = (-n) % blk
    s = jnp.pad(score, ((0, 0), (0, pad)), constant_values=-1.0)
    rows = s.reshape(nb, -1, blk)
    kb = min(kb, cap)
    v1, i1 = jax.lax.top_k(rows, kb)                 # (B, nblk, kb)
    saturated = jnp.any(v1[:, :, -1] > 0.0)
    base = jnp.arange(rows.shape[1], dtype=jnp.int32)[None, :, None] * blk
    flat_idx = (i1 + base).reshape(nb, -1)
    k2 = min(cap, flat_idx.shape[1])

    def fast(_):
        v2, i2 = jax.lax.top_k(v1.reshape(nb, -1), k2)
        return v2, jnp.take_along_axis(flat_idx, i2, axis=1)

    def exact(_):
        v2, i2 = jax.lax.top_k(s, k2)
        return v2, i2.astype(jnp.int32)

    out_v, out_i = jax.lax.cond(saturated, exact, fast, operand=None)
    if k2 < cap:
        out_v = jnp.pad(out_v, ((0, 0), (0, cap - k2)),
                        constant_values=-1.0)
        out_i = jnp.pad(out_i, ((0, 0), (0, cap - k2)))
    return out_v, out_i


_G = 16          # windowed-reduction width (see _top_k_windowed)
_KEY_POS_MASK = _G - 1


def _pack_keys(score3: jnp.ndarray) -> jnp.ndarray:
    """Order-preserving int32 sort keys for positive f32 scores.

    Positive IEEE-754 floats compare identically to their bit
    patterns, so (bits & ~15) | (column % 16) ranks by score with the
    low 4 mantissa bits sacrificed to carry the in-window position —
    ties at 19-mantissa-bit resolution break by column, which only
    permutes which near-identical candidate survives cap truncation
    (the reference keeps all extrema, src/sift.cpp:511; order is our
    truncation policy, and refinement re-ranks by contrast anyway).
    Non-candidates map to -1 < every candidate key (|DoG| > 8 means
    exponent >= 130, so candidate keys are large positive ints).
    """
    bits = jax.lax.bitcast_convert_type(score3, jnp.int32)
    pos = jax.lax.broadcasted_iota(
        jnp.int32, score3.shape, score3.ndim - 1) & _KEY_POS_MASK
    return jnp.where(score3 > 0.0, (bits & ~_KEY_POS_MASK) | pos,
                     jnp.int32(-1))


def _window_census(score3: jnp.ndarray, kb: int, blk: int):
    """(per-16-column candidate counts, exactness predicate).

    The windowed fast path is exact iff (a) no 16-column window holds
    > 2 candidates (the two max passes capture at most 2) and (b) no
    4096-key stage-2 block holds > kb candidates (its per-block top_k
    keeps kb). Both are counted EXACTLY here, so the lax.cond fallback
    to the dense two-stage sort makes the whole selection exact.
    """
    ones = (score3 > 0.0).astype(jnp.int32)
    nd = score3.ndim
    win = (1,) * (nd - 1) + (_G,)
    counts = jax.lax.reduce_window(ones, 0, jax.lax.add, win, win,
                                   "VALID")
    wpb = blk // 2                       # windows per 4096-key block
    cf = counts.reshape(counts.shape[:-3] + (-1,))
    pad = (-cf.shape[-1]) % wpb
    cf = jnp.pad(cf, [(0, 0)] * (cf.ndim - 1) + [(0, pad)])
    blk_counts = cf.reshape(cf.shape[:-1] + (-1, wpb)).sum(-1)
    sat = jnp.any(counts > 2) | jnp.any(blk_counts > kb)
    return counts, sat


def _windowed_reduce(score3: jnp.ndarray) -> jnp.ndarray:
    """Two windowed max passes over 16-column windows -> interleaved
    (..., n_windows*2) int32 keys holding every candidate of every
    window with <= 2 candidates (one elementwise pass each; replaces
    the stage-1 block SORT of the two-stage top-k, which sorts 8x more
    keys for the same selection)."""
    keys = _pack_keys(score3)
    nd = keys.ndim
    win = (1,) * (nd - 1) + (_G,)
    imin = jnp.iinfo(jnp.int32).min
    w1 = jax.lax.reduce_window(keys, imin, jax.lax.max, win, win,
                               "VALID")
    # keys are unique within a window (position bits), so == excises
    # exactly the first winner
    masked = jnp.where(keys == jnp.repeat(w1, _G, axis=-1), imin, keys)
    w2 = jax.lax.reduce_window(masked, imin, jax.lax.max, win, win,
                               "VALID")
    return jnp.stack([w1, w2], axis=-1).reshape(keys.shape[:-2] + (-1,))


def _unpack_keys(keyvals: jnp.ndarray, positions: jnp.ndarray):
    """(top-k key values, their positions in the interleaved reduced
    array) -> (score values (truncated mantissa), flat pixel indices)."""
    win = positions // 2
    col = keyvals & _KEY_POS_MASK
    flat = win * _G + col
    vals = jax.lax.bitcast_convert_type(keyvals & ~_KEY_POS_MASK,
                                        jnp.float32)
    return jnp.where(keyvals > 0, vals, -1.0), flat.astype(jnp.int32)


def _top_k_windowed(score3: jnp.ndarray, cap: int, blk: int = 4096,
                    kb: int = 128):
    """Exact top-cap candidate extraction from a dense (nl, H, W)
    score field: candidates are ~1e-4 dense, so two 16-column
    windowed max passes (bandwidth-bound elementwise work) shrink the
    sort problem 8x before any top_k runs. An exact census arms a
    lax.cond fallback to the dense two-stage sort for inputs too
    clustered for the window capacity (never observed on real frames;
    plateaus from the reference's >=/<= extremum rule can do it).

    W must be a multiple of 16 (callers pad with -1 scores).
    Returns (vals, flat_idx) in (nl*H*W) row-major coordinates.
    """
    kb = min(kb, cap)
    n = score3.size
    counts, sat = _window_census(score3, kb, blk)

    def exact(s3):
        return _top_k_two_stage(s3.reshape(-1), cap, blk, kb)

    def fast(s3):
        red = _windowed_reduce(s3).reshape(-1)       # (2 * n/16,)
        pad = (-red.shape[0]) % blk
        red = jnp.pad(red, (0, pad), constant_values=-1)
        rows = red.reshape(-1, blk)
        v1, i1 = jax.lax.top_k(rows, kb)
        base = jnp.arange(rows.shape[0], dtype=jnp.int32)[:, None] * blk
        flat1 = (i1 + base).reshape(-1)
        k2 = min(cap, flat1.shape[0])
        v2, j2 = jax.lax.top_k(v1.reshape(-1), k2)
        vals, idx = _unpack_keys(v2, flat1[j2])
        if k2 < cap:
            vals = jnp.pad(vals, (0, cap - k2), constant_values=-1.0)
            idx = jnp.pad(idx, (0, cap - k2))
        return vals, jnp.minimum(idx, n - 1)

    return jax.lax.cond(sat, exact, fast, score3)


def _top_k_windowed_batch(score4: jnp.ndarray, cap: int,
                          blk: int = 4096, kb: int = 128):
    """Batched (B, nl, H, W) variant of _top_k_windowed. Like
    _top_k_two_stage_batch, the exactness cond stays at batch level
    (under vmap it would lower to select and always pay the dense
    sort)."""
    kb = min(kb, cap)
    nb = score4.shape[0]
    n = score4[0].size
    counts, sat = _window_census(score4, kb, blk)

    def exact(s4):
        return _top_k_two_stage_batch(s4.reshape(nb, -1), cap, blk, kb)

    def fast(s4):
        red = _windowed_reduce(s4).reshape(nb, -1)
        pad = (-red.shape[1]) % blk
        red = jnp.pad(red, ((0, 0), (0, pad)), constant_values=-1)
        rows = red.reshape(nb, -1, blk)
        v1, i1 = jax.lax.top_k(rows, kb)
        base = jnp.arange(rows.shape[1], dtype=jnp.int32)[None, :, None] * blk
        flat1 = (i1 + base).reshape(nb, -1)
        k2 = min(cap, flat1.shape[1])
        v2, j2 = jax.lax.top_k(v1.reshape(nb, -1), k2)
        vals, idx = _unpack_keys(v2, jnp.take_along_axis(flat1, j2,
                                                         axis=1))
        if k2 < cap:
            vals = jnp.pad(vals, ((0, 0), (0, cap - k2)),
                           constant_values=-1.0)
            idx = jnp.pad(idx, ((0, 0), (0, cap - k2)))
        return vals, jnp.minimum(idx, n - 1)

    return jax.lax.cond(sat, exact, fast, score4)


def top_candidates_batch(dog: jnp.ndarray, cap: int,
                         cfg: SIFTConfig = DEFAULT_CONFIG
                         ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                    jnp.ndarray, jnp.ndarray]:
    """Batched frames: (B, D, H, W) -> (layer, r, c, valid), each
    (B, cap). Same semantics per frame as top_candidates."""
    nl = cfg.n_octave_layers
    nb, _, h, w = dog.shape
    mask = jax.vmap(lambda d: extrema_mask(d, cfg))(dog)
    score3 = jnp.where(mask, jnp.abs(dog[:, 1:1 + nl]), -1.0)
    n = score3[0].size
    k = min(cap, n)
    if n <= 8192 or n <= cap:
        vals, idx = _top_k_two_stage_batch(score3.reshape(nb, -1), k)
        wp = w
    else:
        padw = (-w) % _G
        score3 = jnp.pad(score3, ((0, 0), (0, 0), (0, 0), (0, padw)),
                         constant_values=-1.0)
        wp = w + padw
        vals, idx = _top_k_windowed_batch(score3, k)
    if k < cap:
        vals = jnp.pad(vals, ((0, 0), (0, cap - k)),
                       constant_values=-1.0)
        idx = jnp.pad(idx, ((0, 0), (0, cap - k)))
    layer = idx // (h * wp) + 1
    rem = idx % (h * wp)
    return (layer.astype(jnp.int32), (rem // wp).astype(jnp.int32),
            jnp.minimum(rem % wp, w - 1).astype(jnp.int32), vals > 0.0)


def top_candidates(dog: jnp.ndarray, cap: int,
                   cfg: SIFTConfig = DEFAULT_CONFIG
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                              jnp.ndarray]:
    """Surface up to `cap` NMS candidates ranked by |DoG response|.

    Returns (layer, r, c, valid), each (cap,). layer is the absolute
    DoG layer index (1..nL).
    """
    nl = cfg.n_octave_layers
    h, w = dog.shape[1], dog.shape[2]
    mask = extrema_mask(dog, cfg)
    score3 = jnp.where(mask, jnp.abs(dog[1:1 + nl]), -1.0)
    n = score3.size
    k = min(cap, n)
    if n <= 8192 or n <= cap:   # tiny octave: plain exact top_k
        vals, idx = _top_k_two_stage(score3.reshape(-1), k)
        wp = w
    else:
        padw = (-w) % _G
        score3 = jnp.pad(score3, ((0, 0), (0, 0), (0, padw)),
                         constant_values=-1.0)
        wp = w + padw
        vals, idx = _top_k_windowed(score3, k)
    if k < cap:  # pad back up to the static cap
        vals = jnp.pad(vals, (0, cap - k), constant_values=-1.0)
        idx = jnp.pad(idx, (0, cap - k))
    layer = idx // (h * wp) + 1
    rem = idx % (h * wp)
    r = rem // wp
    c = jnp.minimum(rem % wp, w - 1)
    valid = vals > 0.0
    return (layer.astype(jnp.int32), r.astype(jnp.int32),
            c.astype(jnp.int32), valid)
