"""sift_tpu — SIFT + SfM framework in JAX.

A from-scratch JAX/XLA rebuild with the capabilities of
canhld94/SIFT-GPU (CPU SIFT + matching + RANSAC homography demo),
extended per the north star with RANSAC geometry, incremental SfM and
distributed bundle adjustment over device meshes.
"""

__version__ = "0.1.0"

from sift_tpu.config import SIFTConfig, DEFAULT_CONFIG
from sift_tpu.types import Keypoints

__all__ = ["SIFTConfig", "DEFAULT_CONFIG", "Keypoints", "__version__"]
