"""Incremental SfM back-end: bundle adjustment, PnP, pose graphs.

New capability per the north star (BASELINE.json): the reference ends
at a 2-D homography; this package adds the 3-D reconstruction stack,
built for batched accelerator execution — static-shape masked observation tables, batched
small-block linear algebra, and a matrix-free Schur-complement bundle
adjuster whose hot loop is segment-sums + batched 3x3 solves, the
exact shape that shards over device meshes with psum.
"""

from sift_tpu.sfm.ba import BAProblem, bundle_adjust, reproj_rmse
from sift_tpu.sfm.incremental import Reconstruction, reconstruct
from sift_tpu.sfm.posegraph import PoseGraph, optimize_pose_graph
from sift_tpu.sfm.posegraph_dist import optimize_pose_graph_partitioned
from sift_tpu.sfm.loopclosure import LoopClosure, find_loop_closures
from sift_tpu.sfm.rotation_avg import average_rotations
from sift_tpu.sfm.export import save_ply, save_reconstruction
from sift_tpu.sfm.mapping import (MappingResult, mapping_ate,
                                  render_corner_sequence, run_mapping)

__all__ = ["BAProblem", "bundle_adjust", "reproj_rmse",
           "Reconstruction", "reconstruct",
           "PoseGraph", "optimize_pose_graph",
           "optimize_pose_graph_partitioned",
           "LoopClosure", "find_loop_closures",
           "average_rotations", "save_ply", "save_reconstruction",
           "MappingResult", "mapping_ate", "render_corner_sequence",
           "run_mapping"]
