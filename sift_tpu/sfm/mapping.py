"""Config-5 end-to-end mapping pipeline (BASELINE.json north star).

Composes the whole framework into one gated flow — the map-scale
counterpart of the reference's two-image demo (src/main.cpp:10-72):

  image sequence
    -> detect + describe (full SIFT front-end, per frame)
    -> sequential pairwise matching (ops.match)
    -> incremental SfM (sfm.incremental: tracks, essential init,
       PnP registration, windowed Schur/CG BA)
    -> loop-closure detection (sfm.loopclosure: signature retrieval
       + cascade matcher + essential verification)
    -> scale-resolved closure edges via PnP against the live map
    -> pose-graph correction (sfm.posegraph: odometry + closure edges)
    -> final global BA with the closure observations folded into the
       track graph, initialized from the corrected trajectory
    -> PLY / JSON export (sfm.export)

The harness renders its own image sequence: `render_corner_sequence`
texture-maps seeded procedural textures (sift_tpu.synth) onto the four
planes of a concave box corner and renders a known closed camera loop through it (planar homography
per plane — exact pinhole geometry, real parallax between the planes,
genuinely revisited viewpoints for the loop-closure stage). Ground
truth poses make the ATE gates exact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from sift_tpu.geometry import lie
from sift_tpu.geometry.pnp import pnp_ransac
from sift_tpu.sfm.ba import bundle_adjust, reproj_rmse
from sift_tpu.sfm.incremental import (Reconstruction, _ObsTable,
                                      _ba_tables, reconstruct)
from sift_tpu.sfm.loopclosure import LoopClosure, find_loop_closures
from sift_tpu.sfm.posegraph import PoseGraph, optimize_pose_graph
from sift_tpu.utils.caps import pow2_cap
from sift_tpu.utils.metrics import ate_rmse, camera_centers


# ---------------------------------------------------------------------------
# procedural-texture sequence renderer
# ---------------------------------------------------------------------------

# (origin, u-axis, v-axis) of each textured plane, world units; the
# four planes form a concave box corner (back wall, floor, ceiling,
# left wall) so no plane ever occludes another from the camera region
_PLANES = [
    ((-3.0, -2.0, 6.0), (6.0, 0.0, 0.0), (0.0, 4.0, 0.0)),   # back
    ((-3.0, 2.0, 2.0), (6.0, 0.0, 0.0), (0.0, 0.0, 4.0)),    # floor
    ((-3.0, -2.0, 2.0), (6.0, 0.0, 0.0), (0.0, 0.0, 4.0)),   # ceiling
    ((-3.0, -2.0, 2.0), (0.0, 0.0, 4.0), (0.0, 4.0, 0.0)),   # left wall
]

_TEXTURE_HW = (480, 640)      # texture map size per plane


def _look_at(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->cam rotation with +z forward, +y down (pinhole rows)."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])


def render_corner_sequence(n_frames: int = 24,
                           size: Tuple[int, int] = (240, 320),
                           radius: float = 0.9,
                           seed: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a closed camera loop through the textured corner.

    Each plane carries its own seeded procedural texture
    (sift_tpu.synth.procedural_texture, seeds seed*4 + plane index).

    Returns (frames (F, H, W) float32 0-255, K (3, 3),
    gt_cams (F, 6) [w|t] world->cam). The trajectory is a circle in
    the x/z plane (plus a small y bob) that returns to its start, so
    the last frames revisit the first frames' viewpoint — a real loop
    closure for the retrieval stage, not a synthetic edge.
    """
    from sift_tpu import synth
    h, w = size
    f = 0.9 * w
    k = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(seed)

    texs = [synth.procedural_texture(*_TEXTURE_HW, seed=seed * 4 + i)
            for i in range(len(_PLANES))]

    frames = np.zeros((n_frames, h, w), np.float32)
    cams = np.zeros((n_frames, 6), np.float64)
    for i in range(n_frames):
        th = 2.0 * np.pi * i / n_frames
        center = np.array([radius * np.sin(th),
                           0.25 * np.sin(2 * th),
                           0.35 * radius * (1.0 - np.cos(th))])
        target = np.array([0.6 * np.sin(th), 0.0, 6.0])
        r = _look_at(center, target)
        t = -r @ center
        cams[i, :3] = np.asarray(
            lie.so3_log(jnp.asarray(r, jnp.float32)))
        cams[i, 3:] = t
        canvas = np.zeros((h, w), np.float32)
        covered = np.zeros((h, w), bool)
        for (o, u, v), tex in zip(_PLANES, texs):
            th_, tw_ = tex.shape
            m = np.stack([r @ np.asarray(u), r @ np.asarray(v),
                          r @ np.asarray(o) + t], axis=1)
            hom = k @ m @ np.diag([1.0 / (tw_ - 1), 1.0 / (th_ - 1), 1.0])
            warped, mask = synth.warp_perspective(tex, hom, (h, w))
            put = mask & ~covered
            canvas[put] = warped[put]
            covered |= mask
        # mild sensor noise so repeated texture does not match exactly
        canvas += rng.normal(0.0, 1.0, canvas.shape)
        frames[i] = np.clip(canvas, 0.0, 255.0)
    return frames, k, cams


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MappingResult:
    """End-to-end mapping output (host-side NumPy)."""
    rec: Reconstruction            # sequential-odometry reconstruction
    closures: List[LoopClosure]
    cameras_pg: np.ndarray         # (F, 6) pose-graph-corrected
    cameras_final: np.ndarray      # (F, 6) after closure-aware global BA
    points_final: np.ndarray       # (T, 3)
    has_point: np.ndarray          # (T,) bool
    registered: np.ndarray         # (F,) bool
    reproj_rmse: float
    stats: Dict


def _detect_all(frames: np.ndarray, cfg) -> Tuple[List[np.ndarray],
                                                  List[np.ndarray],
                                                  List[np.ndarray]]:
    from sift_tpu import sift
    descs, valids, xy = [], [], []
    for f in frames:          # same shape every frame -> one compile
        kp, d = sift.detect_and_compute(jnp.asarray(f), cfg)
        descs.append(np.asarray(d))
        valids.append(np.asarray(kp.valid))
        xy.append(np.stack([np.asarray(kp.x), np.asarray(kp.y)], 1))
    return descs, valids, xy


def _sequential_matches(descs, valids, xy_n, pair_window: int,
                        ratio: float) -> Dict[Tuple[int, int], np.ndarray]:
    from sift_tpu.ops.match import match_ratio
    out: Dict[Tuple[int, int], np.ndarray] = {}
    n = len(descs)
    for i in range(n):
        for j in range(i + 1, min(i + 1 + pair_window, n)):
            m = match_ratio(jnp.asarray(descs[i]), jnp.asarray(descs[j]),
                            q_valid=jnp.asarray(valids[i]),
                            t_valid=jnp.asarray(valids[j]), ratio=ratio)
            good = np.asarray(m.good)
            qi = np.where(good)[0]
            if len(qi) >= 8:
                out[(i, j)] = np.stack(
                    [qi, np.asarray(m.train_idx)[qi]], axis=1)
    return out


def _rel_pose(a6: np.ndarray, b6: np.ndarray) -> np.ndarray:
    """Relative [w|t] of edge a->b (posegraph convention T_a^-1 T_b)."""
    ra = np.asarray(lie.so3_exp(jnp.asarray(a6[:3], jnp.float32)))
    rb = np.asarray(lie.so3_exp(jnp.asarray(b6[:3], jnp.float32)))
    r = ra.T @ rb
    t = ra.T @ (b6[3:] - a6[3:])
    return np.concatenate([np.asarray(lie.so3_log(
        jnp.asarray(r, jnp.float32))), t])


def _closure_pnp_edges(rec: Reconstruction, closures, xy_n,
                       threshold: float) -> List[Tuple[int, int,
                                                       np.ndarray, int]]:
    """Scale-resolved closure edges: PnP of frame j against the live
    map points observed in frame i through the closure's 2D-2D
    matches. The raw closure rel_pose from essential decomposition has
    unit-norm translation (monocular scale ambiguity); anchoring it to
    the map via 2D-3D PnP gives a metric edge in the map's gauge."""
    kpt2track: List[Dict[int, int]] = [dict() for _ in xy_n]
    for t_id, tr in enumerate(rec.tracks):
        if rec.has_point[t_id]:
            for f, kidx in tr.items():
                kpt2track[f][kidx] = t_id
    edges = []
    for c in closures:
        ks = [(ki, kj) for ki, kj in c.matches
              if ki in kpt2track[c.i]]
        if len(ks) < 8:
            continue
        tids = np.array([kpt2track[c.i][ki] for ki, _ in ks])
        x3 = rec.points[tids]
        p2 = xy_n[c.j][np.array([kj for _, kj in ks])]
        cap = pow2_cap(len(ks), lo=16)
        pad = cap - len(ks)
        x3p = np.concatenate([x3, np.zeros((pad, 3))]).astype(np.float32)
        p2p = np.concatenate([p2, np.zeros((pad, 2))]).astype(np.float32)
        ok = np.array([True] * len(ks) + [False] * pad)
        pres = pnp_ransac(jnp.asarray(x3p), jnp.asarray(p2p),
                          valid=jnp.asarray(ok), threshold=threshold)
        if not bool(np.asarray(pres.ok)):
            continue
        cam_j = np.concatenate([
            np.asarray(lie.so3_log(pres.R)), np.asarray(pres.t)])
        rel = _rel_pose(rec.cameras[c.i], cam_j)
        edges.append((c.i, c.j, rel, int(np.asarray(pres.n_inliers))))
    return edges


def _pose_graph_correct(rec: Reconstruction, closure_edges,
                        closure_weight: float = 4.0,
                        iters: int = 30) -> np.ndarray:
    """Odometry edges between consecutive registered frames (from the
    incremental trajectory) + metric closure edges -> corrected
    trajectory. Unregistered frames are marked fixed so their dummy
    poses stay out of the solve."""
    n = len(rec.cameras)
    reg = np.where(rec.registered)[0]
    ei, ej, rels, w = [], [], [], []
    for a, b in zip(reg[:-1], reg[1:]):
        ei.append(a)
        ej.append(b)
        rels.append(_rel_pose(rec.cameras[a], rec.cameras[b]))
        w.append(1.0)
    for (i, j, rel, n_inl) in closure_edges:
        ei.append(i)
        ej.append(j)
        rels.append(rel)
        w.append(closure_weight)
    fixed = ~rec.registered.copy()
    fixed[reg[0]] = True
    g = PoseGraph(
        poses=jnp.asarray(rec.cameras, jnp.float32),
        edges_i=jnp.asarray(np.array(ei, np.int32)),
        edges_j=jnp.asarray(np.array(ej, np.int32)),
        rel=jnp.asarray(np.array(rels), jnp.float32),
        weight=jnp.asarray(np.array(w), jnp.float32),
        mask=jnp.ones(len(ei), bool),
        fixed=jnp.asarray(fixed))
    out = optimize_pose_graph(g, iters=iters)
    return np.asarray(out.poses, np.float64)


def _prune_table(table: _ObsTable, cameras, registered, points,
                 has_point, max_err: float) -> int:
    """Drop observations whose reprojection error exceeds max_err
    (vectorized over the flat table); tracks left with < 2 registered
    observations lose their point. Returns observations removed."""
    usable = registered & np.isfinite(cameras).all(axis=1)
    sel = table.alive & usable[table.frame] & has_point[table.track]
    idx = np.where(sel)[0]
    if not len(idx):
        return 0
    f = table.frame[idx].astype(np.int64)
    t = table.track[idx].astype(np.int64)
    rw = np.stack([np.asarray(lie.so3_exp(
        jnp.asarray(c, jnp.float32))) for c in cameras[:, :3]])
    xc = np.einsum("oij,oj->oi", rw[f], points[t]) + cameras[f, 3:]
    z = xc[:, 2]
    err = np.linalg.norm(
        xc[:, :2] / np.maximum(z, 1e-12)[:, None] - table.uv[idx],
        axis=1)
    bad = (z <= 1e-6) | (err > max_err)
    table.alive[idx[bad]] = False
    cnt = np.bincount(table.track[table.alive & usable[table.frame]],
                      minlength=len(has_point))
    has_point[cnt < 2] = False
    return int(bad.sum())


def run_mapping(frames: np.ndarray, k: np.ndarray,
                cfg=None,
                pair_window: int = 3,
                ratio: float = 0.86,
                min_gap: int = 6,
                closure_candidates: int = 2,
                ransac_threshold: float = 2e-3,
                ba_window: Optional[int] = 8,
                export_prefix: Optional[str] = None) -> MappingResult:
    """Run the full config-5 pipeline on an (F, H, W) image sequence.

    `k` is the (3, 3) pinhole intrinsics matrix of the sequence.
    """
    from sift_tpu.config import DEFAULT_CONFIG
    cfg = cfg or DEFAULT_CONFIG
    descs, valids, xy = _detect_all(frames, cfg)
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    xy_n = [np.stack([(p[:, 0] - cx) / fx, (p[:, 1] - cy) / fy], 1)
            .astype(np.float32) for p in xy]

    seq = _sequential_matches(descs, valids, xy_n, pair_window, ratio)
    rec = reconstruct(xy_n, seq, ransac_threshold=ransac_threshold,
                      ba_window=ba_window)

    closures = find_loop_closures(descs, valids, xy_n, min_gap=min_gap,
                                  candidates_per_frame=closure_candidates,
                                  ransac_threshold=ransac_threshold,
                                  ratio=ratio)
    closure_edges = _closure_pnp_edges(rec, closures, xy_n,
                                       ransac_threshold)
    if closure_edges:
        cameras_pg = _pose_graph_correct(rec, closure_edges)
    else:
        cameras_pg = rec.cameras.copy()

    # final global BA: closure matches join the track graph as new
    # observations of existing tracks; cameras start from the
    # pose-graph-corrected trajectory
    tracks = [dict(tr) for tr in rec.tracks]
    kpt2track: List[Dict[int, int]] = [dict() for _ in xy_n]
    for t_id, tr in enumerate(tracks):
        for f, kidx in tr.items():
            kpt2track[f][kidx] = t_id
    n_closure_obs = 0
    for c in closures:
        for ki, kj in c.matches:
            t_i = kpt2track[c.i].get(int(ki))
            t_j = kpt2track[c.j].get(int(kj))
            if t_i is None or not rec.has_point[t_i]:
                continue
            if t_j is None and c.j not in tracks[t_i]:
                tracks[t_i][c.j] = int(kj)
                kpt2track[c.j][int(kj)] = t_i
                n_closure_obs += 1
    table = _ObsTable(tracks, xy_n, len(xy_n))
    cameras = cameras_pg.copy()
    points = rec.points.copy()
    has_point = rec.has_point.copy()
    anchor = int(np.where(rec.registered)[0][0])
    rmse = np.inf
    # BA -> prune wrong-correspondence observations (closure matches
    # are ratio-tested but unverified per-observation) -> BA again
    for _ in range(2):
        prob, live = _ba_tables(table, cameras, rec.registered, points,
                                has_point, anchor_frame=anchor)
        out = bundle_adjust(prob, iters=24, loss="cauchy",
                            huber_delta=ransac_threshold)
        cameras[rec.registered] = np.asarray(out.cameras)[rec.registered]
        points[live] = np.asarray(out.points)[:len(live)]
        rmse = float(np.asarray(reproj_rmse(out)))
        n_bad = _prune_table(table, cameras, rec.registered, points,
                             has_point, 4.0 * ransac_threshold)
        if n_bad == 0:
            break

    result = MappingResult(
        rec=rec, closures=closures, cameras_pg=cameras_pg,
        cameras_final=cameras, points_final=points,
        has_point=has_point, registered=rec.registered,
        reproj_rmse=rmse,
        stats={
            "n_frames": len(frames),
            "n_registered": int(rec.registered.sum()),
            "n_points": int(has_point.sum()),
            "n_seq_pairs": len(seq),
            "n_closures": len(closures),
            "n_closure_edges": len(closure_edges),
            "n_closure_obs": n_closure_obs,
            "reproj_rmse": rmse,
        })
    if export_prefix is not None:
        from sift_tpu.sfm.export import save_reconstruction
        final = Reconstruction(
            cameras=cameras, registered=rec.registered,
            points=points, has_point=has_point,
            tracks=tracks, reproj_rmse=rmse)
        result.stats["export"] = save_reconstruction(export_prefix,
                                                     final)
    return result


def main(argv=None) -> int:
    """CLI: map an image sequence (a directory of frames, sorted by
    name) and export the reconstruction.

    python -m sift_tpu.sfm.mapping <frames_dir> --out map \
        [--fov-deg 58] [--fx F --fy F --cx C --cy C]

    Without explicit intrinsics, fx=fy is derived from --fov-deg and
    the principal point sits at the image center (the reference demo
    never calibrates at all — src/main.cpp:79-87 just resizes).
    """
    import argparse
    import glob
    import json
    import math

    ap = argparse.ArgumentParser(prog="sift_tpu.sfm.mapping")
    ap.add_argument("frames_dir")
    ap.add_argument("--out", default="map",
                    help="export prefix (-> .ply / .json)")
    ap.add_argument("--fov-deg", type=float, default=58.0)
    ap.add_argument("--fx", type=float)
    ap.add_argument("--fy", type=float)
    ap.add_argument("--cx", type=float)
    ap.add_argument("--cy", type=float)
    ap.add_argument("--max-side", type=int, default=640)
    ap.add_argument("--pair-window", type=int, default=3)
    args = ap.parse_args(argv)

    import cv2
    paths = sorted(p for p in glob.glob(f"{args.frames_dir}/*")
                   if p.lower().endswith((".jpg", ".jpeg", ".png",
                                          ".bmp")))
    if len(paths) < 3:
        print(f"need >= 3 frames, found {len(paths)}", flush=True)
        return 2
    frames = []
    for p in paths:
        g = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        s = max(g.shape) / args.max_side
        if s > 1.0:
            g = cv2.resize(g, (int(g.shape[1] / s), int(g.shape[0] / s)))
        frames.append(g)
    hw = frames[0].shape
    if any(f.shape != hw for f in frames):
        print("all frames must share one resolution", flush=True)
        return 2
    h, w = hw
    fx = args.fx or w / (2.0 * math.tan(math.radians(args.fov_deg) / 2))
    k = np.array([[fx, 0.0, args.cx if args.cx else w / 2.0],
                  [0.0, args.fy or fx, args.cy if args.cy else h / 2.0],
                  [0.0, 0.0, 1.0]])
    res = run_mapping(np.stack(frames), k,
                      pair_window=args.pair_window,
                      export_prefix=args.out)
    print(json.dumps(res.stats))
    return 0


def mapping_ate(result: MappingResult, gt_cams: np.ndarray
                ) -> Dict[str, float]:
    """ATE (sim3-aligned RMSE of camera centers) of each pipeline
    stage against ground truth, over registered frames."""
    reg = result.registered
    gt = camera_centers(gt_cams[reg])
    return {
        "ate_odometry": ate_rmse(
            camera_centers(result.rec.cameras[reg]), gt),
        "ate_posegraph": ate_rmse(
            camera_centers(result.cameras_pg[reg]), gt),
        "ate_final": ate_rmse(
            camera_centers(result.cameras_final[reg]), gt),
    }


if __name__ == "__main__":
    import sys
    sys.exit(main())
