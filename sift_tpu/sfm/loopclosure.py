"""Loop-closure detection from descriptor retrieval (north-star
config 5; no reference counterpart — the reference is a two-image
demo, SURVEY.md §2).

Two-level retrieval, both dense and batched:

  1. frame-level candidate selection: each frame gets a compact
     signature — the mean of its descriptors projected through the
     cascade matcher's seeded random matrix (one small GEMM per
     frame). Cosine similarity over signatures ranks candidate pairs;
     only temporally distant frames (>= min_gap) qualify, so odometry
     neighbors don't masquerade as closures.
  2. pair-level verification: candidate pairs run the cascade
     descriptor matcher + essential-matrix RANSAC; a closure is
     accepted only with enough geometric inliers.

Accepted closures are returned as a matches dict fragment compatible
with sfm.incremental.reconstruct (their observations then join the
track graph / BA) and as relative-pose edges for
sfm.posegraph.PoseGraph.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from sift_tpu.geometry import lie
from sift_tpu.geometry.epipolar import find_essential_ransac
from sift_tpu.ops.match_cascade import match_ratio_cascade, _projection
from sift_tpu.utils.caps import pow2_cap


class LoopClosure(NamedTuple):
    i: int
    j: int
    matches: np.ndarray      # (M, 2) keypoint index pairs (i, j)
    n_inliers: int
    rel_pose: np.ndarray     # (6,) [w|t] frame i -> frame j (unit t)


def frame_signatures(descriptors: Sequence[np.ndarray],
                     valids: Sequence[np.ndarray],
                     d_proj: int = 16, seed: int = 7) -> np.ndarray:
    """(F, d') L2-normalized retrieval signatures."""
    proj = np.asarray(_projection(descriptors[0].shape[1], d_proj, seed))
    sigs = []
    for d, v in zip(descriptors, valids):
        dv = np.asarray(d)[np.asarray(v)]
        s = (dv @ proj).mean(axis=0) if len(dv) else np.zeros(d_proj)
        sigs.append(s / max(np.linalg.norm(s), 1e-12))
    return np.stack(sigs).astype(np.float32)


def find_loop_closures(descriptors: Sequence[np.ndarray],
                       valids: Sequence[np.ndarray],
                       kp_xy: Sequence[np.ndarray],
                       min_gap: int = 5,
                       candidates_per_frame: int = 2,
                       min_sim: float = 0.6,
                       min_matches: int = 24,
                       min_inliers: int = 16,
                       ransac_threshold: float = 2e-3,
                       ratio: float = 0.86) -> List[LoopClosure]:
    """Detect and geometrically verify loop closures.

    kp_xy must be NORMALIZED (calibrated) coordinates, matching
    sfm.incremental.reconstruct's convention.
    """
    n_frames = len(descriptors)
    sigs = frame_signatures(descriptors, valids)
    sim = sigs @ sigs.T

    pairs = []
    for j in range(n_frames):
        cand = [i for i in range(n_frames)
                if abs(j - i) >= min_gap and sim[i, j] >= min_sim]
        cand.sort(key=lambda i: -sim[i, j])
        for i in cand[:candidates_per_frame]:
            pairs.append((min(i, j), max(i, j)))
    pairs = sorted(set(pairs))

    closures: List[LoopClosure] = []
    for i, j in pairs:
        m = match_ratio_cascade(
            jnp.asarray(descriptors[j]), jnp.asarray(descriptors[i]),
            q_valid=jnp.asarray(valids[j]),
            t_valid=jnp.asarray(valids[i]), ratio=ratio)
        good = np.asarray(m.good)
        if good.sum() < min_matches:
            continue
        qi = np.where(good)[0]
        ti = np.asarray(m.train_idx)[qi]
        p_i = kp_xy[i][ti]
        p_j = kp_xy[j][qi]
        cap = pow2_cap(len(p_i), lo=16)
        pad = cap - len(p_i)
        valid = np.array([True] * len(p_i) + [False] * pad)
        p_i_p = np.concatenate([p_i, np.zeros((pad, 2))]).astype(np.float32)
        p_j_p = np.concatenate([p_j, np.zeros((pad, 2))]).astype(np.float32)
        res = find_essential_ransac(jnp.asarray(p_i_p),
                                    jnp.asarray(p_j_p),
                                    valid=jnp.asarray(valid),
                                    threshold=ransac_threshold)
        n_inl = int(np.asarray(res.n_inliers))
        if not bool(np.asarray(res.ok)) or n_inl < min_inliers:
            continue
        w = np.asarray(lie.so3_log(res.R))
        rel = np.concatenate([w, np.asarray(res.t)]).astype(np.float64)
        closures.append(LoopClosure(
            i=i, j=j, matches=np.stack([ti, qi], axis=1),
            n_inliers=n_inl, rel_pose=rel))
    return closures


def closures_as_matches(closures: Sequence[LoopClosure]
                        ) -> Dict[Tuple[int, int], np.ndarray]:
    """Matches-dict fragment for sfm.incremental.reconstruct."""
    return {(c.i, c.j): c.matches for c in closures}
