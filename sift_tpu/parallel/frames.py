"""Data-parallel SIFT front-end: a batch of frames sharded over devices.

The device-parallel way of scaling the reference's single-image pipeline:
frames are the batch dimension, sharded over the mesh "data" axis;
each chip runs the full detect+describe graph on its local frames
(vmapped), no cross-chip communication until matching/BA. This is the
frame/pair sharding called out in SURVEY.md §2 (parallelism north
star).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.types import Keypoints
from sift_tpu import sift


def batched_detect_and_compute(imgs: jnp.ndarray, mesh: Mesh,
                               cfg: SIFTConfig = DEFAULT_CONFIG
                               ) -> Tuple[Keypoints, jnp.ndarray]:
    """(B, H, W) frames -> (batched Keypoints, (B, N, 128) descriptors).

    B must be divisible by the mesh "data" axis size. Each leaf of the
    returned Keypoints pytree is (B, N)-shaped and sharded over "data".

    cfg.frames_per_chip_mode picks how each chip runs its local
    frames: "batch" = detect_and_compute_batch (the batch rides the
    conv batch axis); "scan" = the single-frame latency graph per local
    frame under lax.map (one compiled program, frames serialized
    on-device — the right mode wherever `bench.py --batch-sweep` shows
    latency dispatch beating the batched path). Both produce the same
    per-frame results.
    """
    if cfg.frames_per_chip_mode == "scan":
        def local(x):
            return jax.lax.map(
                lambda f: sift.detect_and_compute(f, cfg), x)
    else:
        local = functools.partial(sift.detect_and_compute_batch,
                                  cfg=cfg)
    fn = shard_map(local, mesh=mesh,
                   in_specs=P("data"),
                   out_specs=(jax.tree_util.tree_map(
                       lambda _: P("data"),
                       Keypoints.zeros(1)), P("data")),
                   check_vma=False)
    return jax.jit(fn)(imgs)
