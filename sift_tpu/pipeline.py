"""End-to-end object-detection pipeline (replaces reference C1).

The reference demo (src/main.cpp:10-72): extract SIFT on scene and
object, kNN-match object->scene with ratio 0.86, RANSAC homography,
project object corners into the scene. Here the whole flow after
image ingest is ONE jitted graph per (scene shape, object shape) —
detection, description, matching, RANSAC and corner transfer all stay
on device; only the final small result pytree crosses the host
boundary.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.types import Keypoints
from sift_tpu import sift
from sift_tpu.ops import match as match_mod
from sift_tpu.geometry import find_homography_ransac, perspective_transform


class ObjectDetection(NamedTuple):
    """Everything the reference demo computes, as one device pytree."""
    scene_kp: Keypoints
    object_kp: Keypoints
    scene_desc: jnp.ndarray
    object_desc: jnp.ndarray
    matches: match_mod.Matches
    H: jnp.ndarray              # (3, 3) object -> scene
    inliers: jnp.ndarray        # (N,) over match slots
    n_inliers: jnp.ndarray
    found: jnp.ndarray          # () bool
    corners: jnp.ndarray        # (4, 2) object corners in scene coords


@functools.partial(jax.jit, static_argnames=("obj_hw",))
def _geometry(kpo: Keypoints, kps: Keypoints, m: match_mod.Matches,
              obj_hw) -> tuple:
    """Correspondence gather + RANSAC + corner transfer, one jit."""
    src = jnp.stack([kpo.x, kpo.y], axis=1)
    dst = jnp.stack([kps.x[m.train_idx], kps.y[m.train_idx]], axis=1)
    hres = find_homography_ransac(src, dst, valid=m.good)
    h, w = obj_hw
    corners = jnp.array([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]],
                        jnp.float32)                  # src/main.cpp:58-60
    proj = perspective_transform(corners, hres.H)
    return hres, proj


def detect_object(scene_gray: jnp.ndarray, object_gray: jnp.ndarray,
                  cfg: SIFTConfig = DEFAULT_CONFIG) -> ObjectDetection:
    """Full demo flow on two grayscale f32 images (values 0..255).

    Twin of main() (src/main.cpp:10-72): object plays the kNN query
    role (descriptors1), scene the train role (descriptors0).

    Deliberately NOT one jit: each stage (detect, match, geometry) is
    its own jitted program — one fused graph would compile far longer
    while stage dispatch overhead is microseconds, and the
    intermediates never leave the device either way.
    """
    kps, ds = sift.detect_and_compute(scene_gray, cfg)
    kpo, do = sift.detect_and_compute(object_gray, cfg)
    m = match_mod.match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid,
                              ratio=cfg.match_ratio)
    hres, proj = _geometry(kpo, kps, m, tuple(object_gray.shape))
    return ObjectDetection(
        scene_kp=kps, object_kp=kpo, scene_desc=ds, object_desc=do,
        matches=m, H=hres.H, inliers=hres.inliers,
        n_inliers=hres.n_inliers, found=hres.ok, corners=proj)
