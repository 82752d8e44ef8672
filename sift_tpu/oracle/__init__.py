"""CPU oracle: a faithful NumPy twin of the reference SIFT math.

Used only by tests and baseline measurement — never by the JAX path.
"""

from sift_tpu.oracle.cpu_sift import (
    gaussian_kernel_2d,
    gaussian_blur,
    build_gaussian_pyramid,
    build_dog_pyramid,
    find_scale_space_extrema,
    calc_descriptors,
    sift_ncl,
    match_l1_ratio,
)

__all__ = [
    "gaussian_kernel_2d",
    "gaussian_blur",
    "build_gaussian_pyramid",
    "build_dog_pyramid",
    "find_scale_space_extrema",
    "calc_descriptors",
    "sift_ncl",
    "match_l1_ratio",
]
