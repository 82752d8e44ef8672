"""Seeded synthetic inputs (NumPy only): textured scenes, a planar
object pasted under a known homography, and procedural textures.

Every input the smoke run, the benchmark and the tests feed the
pipeline is made here from a seed, so nothing reads an image file and
every result can be checked against a known ground truth (the
homography that placed the object is the answer the reference demo's
RANSAC, src/main.cpp:54, has to recover).

Images are float32 grayscale on the reference's 0..255 scale.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


def textured_image(h: int, w: int, seed: int = 0,
                   blobs_per_mpx: float = 250.0,
                   block: int = 64, block_amp: float = 15.0,
                   wave_amp: float = 10.0, max_blob_sigma: float = 6.0
                   ) -> np.ndarray:
    """Sinusoid + Gaussian blobs of mixed scale/polarity + blocky
    piecewise-constant texture + sensor noise.

    Blob count scales with area so keypoint density is the same at
    every size; each blob is drawn only inside its 3-sigma window, its
    sigma log-uniform in [1.2, max_blob_sigma]. The defaults give
    keypoints per pixel and per octave of the order a natural
    photograph gives (most in octave 0, few in the deep octaves);
    smaller `block`, stronger blocks and waves and more blobs make a
    denser, more distinctive texture.
    """
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.float64)[:, None]
    xx = np.arange(w, dtype=np.float64)[None, :]
    fy, fx = rng.uniform(11.0, 23.0, 2)
    img = 110.0 + wave_amp * np.sin(xx / fx) * np.cos(yy / fy)
    n_blobs = max(8, int(round(blobs_per_mpx * h * w / 1e6)))
    for k in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = np.exp(rng.uniform(np.log(1.2), np.log(max_blob_sigma)))
        a = rng.uniform(50, 120) * (1 if k % 2 == 0 else -1)
        r = int(3 * s) + 1
        y0, y1 = max(0, int(cy) - r), min(h, int(cy) + r + 1)
        x0, x1 = max(0, int(cx) - r), min(w, int(cx) + r + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        gy = np.arange(y0, y1)[:, None] - cy
        gx = np.arange(x0, x1)[None, :] - cx
        img[y0:y1, x0:x1] += a * np.exp(-(gy * gy + gx * gx) / (2 * s * s))
    blocks = rng.uniform(-block_amp, block_amp,
                         (-(-h // block), -(-w // block)))
    img += np.repeat(np.repeat(blocks, block, 0), block, 1)[:h, :w]
    img += rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def procedural_texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A texture map for the corner renderer (sfm.mapping): the
    textured image at a coarser block scale, so the planes carry
    structure at several scales after perspective foreshortening."""
    return textured_image(h, w, seed=seed, blobs_per_mpx=600.0, block=16,
                          block_amp=60.0, wave_amp=35.0, max_blob_sigma=7.0)


def object_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A densely textured planar object (the reference demo's book):
    fine blocks and many blobs, so it keeps enough keypoints after
    the scene's perspective warp."""
    return textured_image(h, w, seed=seed, blobs_per_mpx=900.0, block=8,
                          block_amp=60.0, wave_amp=35.0, max_blob_sigma=7.0)


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray
              ) -> np.ndarray:
    """Bilinear samples of img at float (x, y); callers mask points
    outside [0, w-1] x [0, h-1]."""
    h, w = img.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = np.clip(x - x0, 0.0, 1.0)
    fy = np.clip(y - y0, 0.0, 1.0)
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return ((a * (1 - fx) + b * fx) * (1 - fy)
            + (c * (1 - fx) + d * fx) * fy)


def warp_perspective(src: np.ndarray, H: np.ndarray,
                     out_hw: Tuple[int, int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse-map warp of src by H (src pixel -> output pixel),
    bilinear. Returns (warped float32, coverage mask)."""
    oh, ow = out_hw
    sh, sw = src.shape
    hinv = np.linalg.inv(np.asarray(H, np.float64))
    yy, xx = np.mgrid[0:oh, 0:ow].astype(np.float64)
    den = hinv[2, 0] * xx + hinv[2, 1] * yy + hinv[2, 2]
    den = np.where(np.abs(den) > 1e-12, den, 1e-12)
    sx = (hinv[0, 0] * xx + hinv[0, 1] * yy + hinv[0, 2]) / den
    sy = (hinv[1, 0] * xx + hinv[1, 1] * yy + hinv[1, 2]) / den
    inside = (den > 0) & (sx >= 0) & (sx <= sw - 1) & (sy >= 0) & (sy <= sh - 1)
    out = np.where(inside, _bilinear(src.astype(np.float64), sx, sy), 0.0)
    return out.astype(np.float32), inside


def project(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(N, 2) points through a 3x3 homography, float64."""
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ np.asarray(
        H, np.float64).T
    return p[:, :2] / p[:, 2:3]


class PlanarScene(NamedTuple):
    scene: np.ndarray      # (H, W) float32 0..255
    object: np.ndarray     # (h, w) float32 0..255
    H: np.ndarray          # (3, 3) float64, object pixel -> scene pixel
    corners: np.ndarray    # (4, 2) object corners in scene coordinates


def object_corners(obj_hw: Tuple[int, int]) -> np.ndarray:
    """The reference demo's object corners (src/main.cpp:58-60)."""
    h, w = obj_hw
    return np.array([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]])


def planar_scene(scene_hw: Tuple[int, int] = (1080, 1920),
                 obj_hw: Tuple[int, int] = (240, 320),
                 seed: int = 0, scale: float = 1.4,
                 angle_deg: float = 12.0,
                 perspective: float = 2e-4) -> PlanarScene:
    """A textured scene with a textured planar object pasted under a
    known homography (similarity at `scale`/`angle_deg` about the
    scene centre, plus a mild perspective term), and the object image
    itself — the reference demo's (scene, book) pair with ground truth.
    """
    sh, sw = scene_hw
    oh, ow = obj_hw
    scene = textured_image(sh, sw, seed=seed)
    obj = object_image(oh, ow, seed=seed + 7919)
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    center_obj = np.array([[1, 0, -ow / 2.0], [0, 1, -oh / 2.0], [0, 0, 1]])
    sim = np.array([[scale * c, -scale * s, 0.0],
                    [scale * s, scale * c, 0.0], [0.0, 0.0, 1.0]])
    persp = np.array([[1.0, 0, 0], [0, 1.0, 0],
                      [perspective, 0.5 * perspective, 1.0]])
    to_scene = np.array([[1, 0, sw / 2.0], [0, 1, sh / 2.0], [0, 0, 1]])
    H = to_scene @ sim @ persp @ center_obj
    H = H / H[2, 2]
    warped, inside = warp_perspective(obj, H, scene_hw)
    scene = np.where(inside, warped, scene).astype(np.float32)
    return PlanarScene(scene, obj, H, project(H, object_corners(obj_hw)))


def frame_pair(hw: Tuple[int, int] = (1080, 1920), seed: int = 0,
               shift: int = 37) -> Tuple[np.ndarray, np.ndarray]:
    """Two overlapping frames of one textured world (the second shifted
    `shift` px to the left), for the benchmark's match step."""
    h, w = hw
    world = textured_image(h, w + shift, seed=seed)
    return world[:, :w].copy(), world[:, shift:].copy()
