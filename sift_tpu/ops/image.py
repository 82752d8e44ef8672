"""Image ingest ops (replaces reference C2, src/main.cpp:79-87).

The reference reads with cv::imread (BGR), optionally resizes the
scene to 960x960, and calls cvtColor(..., COLOR_RGB2GRAY) *on BGR
data* — so the R and B luma weights are swapped relative to true luma
(src/main.cpp:84). We reproduce that swapped conversion, including
OpenCV's 8-bit fixed-point rounding, because it shifts every gray
value and therefore every downstream threshold decision.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax

# OpenCV's fixed-point luma weights (15-bit... actually 14-bit shift):
# yuv_shift = 14, R2Y = 4899, G2Y = 9617, B2Y = 1868.
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_SHIFT = 14


def bgr_to_gray_swapped_u8(img_bgr_u8: jnp.ndarray) -> jnp.ndarray:
    """cvtColor(bgr, COLOR_RGB2GRAY) twin on uint8 BGR input.

    Because the reference passes BGR data through the RGB2GRAY path,
    channel 0 (B) receives the R weight and channel 2 (R) the B weight.
    Returns float32 gray in [0, 255] (the reference then converts to
    CV_32FC1 without scaling, src/main.cpp:85).
    """
    b = img_bgr_u8[..., 0].astype(jnp.int32)
    g = img_bgr_u8[..., 1].astype(jnp.int32)
    r = img_bgr_u8[..., 2].astype(jnp.int32)
    y = (b * _R2Y + g * _G2Y + r * _B2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.astype(jnp.float32)


def rgb_to_gray_swapped_u8(img_rgb_u8: jnp.ndarray) -> jnp.ndarray:
    """Same conversion for RGB-ordered input (e.g. loaded via PIL)."""
    return bgr_to_gray_swapped_u8(img_rgb_u8[..., ::-1])


def resize_bilinear_u8(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize with half-pixel centers (cv::INTER_LINEAR model).

    In-graph fallback for cv::resize (src/main.cpp:83). OpenCV's 8-bit
    path uses 11-bit fixed-point interpolation weights; we compute in
    float32 and round, which matches to within 1 LSB.
    """
    h, w = img.shape[0], img.shape[1]
    out = jax.image.resize(img.astype(jnp.float32),
                           (out_h, out_w) + img.shape[2:], method="linear")
    return jnp.clip(jnp.rint(out), 0, 255).astype(img.dtype)


def downsample_nearest_2x(img: jnp.ndarray) -> jnp.ndarray:
    """cv::resize INTER_NEAREST to (cols/2, rows/2) (src/sift.cpp:254):
    dst(y, x) = src(2y, 2x).

    Implemented as reshape + unit slice rather than a strided slice
    (bit-identical; the reshape form needs no strided gather)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[:2 * h2, :2 * w2]
    return x.reshape(h2, 2, w2, 2)[:, 0, :, 0]
