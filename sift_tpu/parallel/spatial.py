"""Spatial tiling: ONE large frame sharded by rows across the mesh.

The SURVEY §5 "long-context analog": the reference bounds per-frame
cost by resizing the scene to 960x960 (src/main.cpp:83); here a 4K+
frame instead spans the mesh — each device owns a horizontal band of
rows, and the stencil structure of the front-end (blur radius <= 9,
orientation radius <= ~17, descriptor radius <= ~41 in octave pixels)
makes one halo exchange per octave sufficient for exact results.

Layout per octave o < tiled_octaves:

  1. every device zeroes the GLOBAL quirk rows/col (the reference's
     Gaussian_Blur zero-pads the last row/col of each octave base,
     src/sift.cpp:116) and rows beyond the true image,
  2. one ppermute pair exchanges `halo` boundary rows with each
     neighbor (edge devices receive ppermute's zero fill — exactly the
     zero padding the single-device convolution sees at image edges),
  3. the whole per-octave pipeline (blur, DoG, NMS+top-k, refine,
     orientation, descriptors) runs devicewise on the haloed band;
     candidates are restricted to the band's core rows so every
     keypoint is found exactly once,
  4. keypoint rows are shifted into global coordinates; the core of
     Gaussian layer nL is decimated into the next octave's band.

Deep octaves (o >= tiled_octaves) are small — their bands would be
thinner than the halo — so the bands are all_gather'ed into the full
octave base and the tail runs replicated (identical on every device).

Refine/orientation/descriptor receive `row_bounds`, the local rows of
the true image edges, so global-border behavior matches the
single-device path bit-for-bit; keypoints within the stencil radius
of an interior band seam see identical data via the halo. Per-device
candidate caps are cfg.detect_caps / cfg.out_caps (a tiled detect can
therefore return up to n_devices x the single-device capacity).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.types import Keypoints
from sift_tpu.ops import conv
from sift_tpu.ops import extrema as ext
from sift_tpu.ops import descriptor as desc_mod
from sift_tpu import sift


def _band_blur(x: jnp.ndarray, sigmas) -> jnp.ndarray:
    """Blur for the haloed band inside shard_map. The quirk zeroing is
    applied by the caller in GLOBAL coordinates (_zero_beyond), so the
    blur itself runs quirk-free."""
    return conv.gaussian_blur_multi(x, sigmas, apply_quirk=False)


def _true_heights(h: int, n_octaves: int):
    out = [h]
    for _ in range(n_octaves - 1):
        out.append(out[-1] // 2)
    return out


def _true_widths(w: int, n_octaves: int):
    return _true_heights(w, n_octaves)


def _zero_beyond(x: jnp.ndarray, gr0, h_true: int, w_true: int
                 ) -> jnp.ndarray:
    """Zero rows outside the global image (above row 0 and at/past the
    quirk row h_true - 1) plus the global last column — the
    getSubMatrix zero-padding + last-row/col quirk at the GLOBAL edge,
    applied before every blur exactly like the single-device path.
    Zeroing rows < 0 matters between chained blurs: the first blur
    leaks image content into an edge device's out-of-image halo rows,
    which the next blur must see as the zero padding the full-image
    convolution would."""
    rows = gr0 + jnp.arange(x.shape[0])
    x = jnp.where(((rows < 0) | (rows >= h_true - 1))[:, None], 0.0, x)
    cols = jnp.arange(x.shape[1])
    return jnp.where((cols >= w_true - 1)[None, :], 0.0, x)


def _exchange_halo(x: jnp.ndarray, halo: int, axis: str, n: int
                   ) -> jnp.ndarray:
    """(Hb, W) -> (Hb + 2*halo, W): neighbors' boundary rows stacked
    above/below; edge devices get ppermute's zero fill (== the
    convolution's zero padding at the global image edge)."""
    down = [(i, i + 1) for i in range(n - 1)]     # my bottom -> next's top
    up = [(i, i - 1) for i in range(1, n)]        # my top -> prev's bottom
    top = jax.lax.ppermute(x[-halo:], axis, down)
    bot = jax.lax.ppermute(x[:halo], axis, up)
    return jnp.concatenate([top, x, bot], axis=0)


def _tiled_octave(band: jnp.ndarray, octave: int, gr0, h_true: int,
                  w_true: int, halo: int, first: bool,
                  cfg: SIFTConfig, axis: str, n: int):
    """One spatially-tiled octave. band: this device's (Hb, W) octave
    base WITHOUT halo; gr0 its first global row. Returns (keypoints,
    descriptors, next band)."""
    sig = cfg.scale_sigmas()
    nl = cfg.n_octave_layers
    hb = band.shape[0]

    padded = _exchange_halo(band, halo, axis, n)    # (hb + 2h, W)
    gr0p = gr0 - halo                               # global row of padded[0]
    if first:
        # createInitialImage: the stored base is the RAW init-blur
        # output; the quirk applies to each blur's input copy only
        base_p = _band_blur(
            _zero_beyond(padded, gr0p, h_true, w_true),
            (cfg.init_blur_sigma,))[0]
    else:
        base_p = padded
    layers = _band_blur(
        _zero_beyond(base_p, gr0p, h_true, w_true), sig[1:])
    gauss = jnp.concatenate([base_p[None], layers], axis=0)
    dog = gauss[1:] - gauss[:-1]

    # candidate scan restricted to core rows inside the global border
    mask = ext.extrema_mask(dog, cfg)
    hp, wp = dog.shape[1], dog.shape[2]
    rows = gr0p + jnp.arange(hp)
    local = jnp.arange(hp)
    b = cfg.img_border
    core = ((local >= halo) & (local < halo + hb)
            & (rows >= b) & (rows < h_true - b))
    cols_ok = jnp.arange(wp) < w_true - b           # left border in mask
    score = jnp.where(mask & core[None, :, None] & cols_ok[None, None, :],
                      jnp.abs(dog[1:1 + nl]), -1.0).reshape(-1)
    cap = min(cfg.detect_caps[octave], score.shape[0])
    vals, idx = ext._top_k_two_stage(score, cap)
    layer0 = (idx // (hp * wp) + 1).astype(jnp.int32)
    rem = idx % (hp * wp)
    r0 = (rem // wp).astype(jnp.int32)
    c0 = (rem % wp).astype(jnp.int32)
    valid0 = vals > 0.0

    row_bounds = (halo - gr0, h_true - gr0 + halo)  # local rows of image
    out_cap = cfg.out_caps[octave]
    kp = sift._octave_tail(gauss, dog, layer0, r0, c0, valid0,
                           octave, cfg, out_cap, row_bounds=row_bounds)
    desc = desc_mod.descriptors_octave(gauss, kp, cfg,
                                       row_bounds=row_bounds)
    scale = float(1 << octave)
    kp = dataclasses.replace(
        kp,
        y=kp.y + gr0p.astype(jnp.float32) * scale,
        r=kp.r + gr0p)

    # next octave base: INTER_NEAREST decimation of the core of layer
    # nL (reference sift.cpp:252-254), reshape not strided slice
    nxt = gauss[nl][halo:halo + hb]
    h2, w2 = hb // 2, wp // 2
    nxt = nxt[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2)[:, 0, :, 0]
    return kp, desc, nxt


def _tail_octaves(base: jnp.ndarray, start_octave: int,
                  cfg: SIFTConfig):
    """Remaining octaves from a full (replicated) octave base, using
    the standard single-device per-octave path."""
    sig = cfg.scale_sigmas()
    nl = cfg.n_octave_layers
    kp_parts, d_parts = [], []
    for o in range(start_octave, cfg.n_octaves):
        if o > start_octave:
            h2, w2 = base.shape[0] // 2, base.shape[1] // 2
            base = base[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2)[:, 0, :, 0]
        layers = conv.gaussian_blur_multi(base, sig[1:])
        gauss = jnp.concatenate([base[None], layers], axis=0)
        dog = gauss[1:] - gauss[:-1]
        if sift._octave_usable(gauss.shape[1:], cfg):
            kp = sift.detect_octave(gauss, dog, o, cfg.detect_caps[o],
                                    cfg, cfg.out_caps[o])
            d = desc_mod.descriptors_octave(gauss, kp, cfg)
        else:
            kp = Keypoints.zeros(cfg.out_caps[o])
            d = jnp.zeros((cfg.out_caps[o], cfg.descr_size), jnp.float32)
        kp_parts.append(kp)
        d_parts.append(d)
        base = gauss[nl]
    return kp_parts, d_parts


def detect_and_compute_tiled(img: jnp.ndarray, mesh: Mesh,
                             cfg: SIFTConfig = DEFAULT_CONFIG,
                             tiled_octaves: int = 2,
                             halo: int = 64
                             ) -> Tuple[Keypoints, jnp.ndarray]:
    """Detect + describe ONE (H, W) frame row-sharded over the mesh.

    Exact per-keypoint parity with sift.detect_and_compute (same
    positions/angles/descriptors); capacity differs — tiled octaves
    carry per-DEVICE caps, so up to n_devices x out_caps[o] keypoints
    per tiled octave. `halo` must cover the in-octave stencil
    (cumulative blur radius ~17 + descriptor radius ~41); 64 default.
    """
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    h, w = img.shape
    ht = _true_heights(h, cfg.n_octaves)
    wt = _true_widths(w, cfg.n_octaves)
    t = tiled_octaves
    # pad rows so every device band halves cleanly through the tiled
    # octaves; padded rows are re-zeroed before every blur
    unit = n * (1 << t)
    hp = -(-h // unit) * unit
    imgp = jnp.pad(img.astype(jnp.float32), ((0, hp - h), (0, 0)))
    hb = hp // n
    if hb // (1 << (t - 1)) < halo:
        raise ValueError(
            f"bands of {hb} rows are too thin for {t} tiled octaves "
            f"with halo {halo}; reduce tiled_octaves or mesh size")

    def local_fn(band):
        dev = jax.lax.axis_index(axis)
        kp_parts, d_parts = [], []
        cur = band
        for o in range(t):
            gr0 = dev * (hb >> o)
            kp, d, cur = _tiled_octave(cur, o, gr0, ht[o], wt[o],
                                       halo, o == 0, cfg, axis, n)
            kp_parts.append(kp)
            d_parts.append(d)
        full = jax.lax.all_gather(cur, axis, axis=0, tiled=True)
        full = full[:ht[t], :wt[t]]
        tail_kp, tail_d = _tail_octaves(full, t, cfg)
        tiled_kp = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                                *kp_parts) if len(kp_parts) > 1 \
            else kp_parts[0]
        tiled_d = jnp.concatenate(d_parts, axis=0)
        rep_kp = Keypoints.concatenate(tuple(tail_kp))
        rep_d = jnp.concatenate(tail_d, axis=0)
        return (jax.tree.map(lambda a: a[None], tiled_kp),
                tiled_d[None], rep_kp, rep_d)

    fn = shard_map(
        local_fn, mesh=mesh, in_specs=P(axis),
        out_specs=(jax.tree_util.tree_map(lambda _: P(axis),
                                          Keypoints.zeros(1)),
                   P(axis), P(), P()),
        check_vma=False)
    tiled_kp, tiled_d, rep_kp, rep_d = jax.jit(fn)(imgp)
    # flatten the device axis of the tiled parts and append the tail
    flat_kp = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                           tiled_kp)
    kp = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                      flat_kp, rep_kp)
    d = jnp.concatenate([tiled_d.reshape(-1, tiled_d.shape[-1]),
                         rep_d], axis=0)
    return kp, d
