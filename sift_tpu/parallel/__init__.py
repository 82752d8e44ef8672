"""Multi-device parallelism over jax.sharding meshes.

The reference's only parallelism is OpenMP threads in one process
(SURVEY.md §2). This package is new capability per the north star:
data-parallel frame sharding for the SIFT front-end, query-sharded
matching, and (back-end) sharded Schur-complement bundle adjustment —
all expressed with shard_map + XLA collectives (NCCL over NVLink on
GPUs).
"""

from sift_tpu.parallel.mesh import make_mesh, default_mesh
from sift_tpu.parallel.frames import batched_detect_and_compute
from sift_tpu.parallel.match import (sharded_match_ratio,
                                     sharded_match_ratio_train_sharded)
from sift_tpu.parallel.ba import (bundle_adjust_sharded,
                                  bundle_adjust_point_sharded)
from sift_tpu.parallel.spatial import detect_and_compute_tiled
from sift_tpu.parallel.elastic import supervise_ba

__all__ = ["make_mesh", "default_mesh", "batched_detect_and_compute",
           "sharded_match_ratio", "sharded_match_ratio_train_sharded",
           "bundle_adjust_sharded", "bundle_adjust_point_sharded",
           "detect_and_compute_tiled", "supervise_ba"]
