"""Incremental structure-from-motion (BASELINE.json config 4).

Host-orchestrated, device-computed: registration order and map growth
are inherently sequential decisions, so a thin NumPy driver owns the
bookkeeping (tracks, which views are registered, which tracks have
points) while every numeric kernel — essential RANSAC, PnP RANSAC,
triangulation, Schur/CG bundle adjustment — runs jitted on device
with static shapes (fixed-capacity masked tables).

Pipeline: feature tracks from pairwise matches (union-find) ->
two-view initialization (essential + triangulate) -> repeated view
registration (PnP on the 2D-3D overlap) + new-track triangulation ->
periodic + final bundle adjustment.

Scaling design (round 3): all bookkeeping runs over a FLAT
observation table (track/frame/kpt/uv/alive arrays, CSR-sorted by
(track, frame)) in bulk NumPy — BA table assembly, observation
pruning, overlap counting, and new-track discovery are O(O) array
passes. The round-2 driver looped per-track Python dicts, which is
O(F * T) per registration and forced its own long-sequence test down
to 15 frames; the reference's equivalent "scaling strategy" was
resizing the input to 960x960 (src/main.cpp:83). Retriangulation is
one vectorized multi-view midpoint pass over every live track (all
registered rays, 3x3 normal equations per track via bincount segment
sums) instead of per-track widest-pair scans that were O(F^2) each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from sift_tpu.geometry import lie
from sift_tpu.geometry.epipolar import find_essential_ransac
from sift_tpu.geometry.pnp import pnp_ransac
from sift_tpu.geometry.triangulation import triangulate
from sift_tpu.sfm.ba import BAProblem, bundle_adjust, reproj_rmse
from sift_tpu.utils.caps import pow2_cap as _pow2


class _UnionFind:
    def __init__(self):
        self.parent: Dict = {}

    def find(self, a):
        p = self.parent.setdefault(a, a)
        while p != self.parent.setdefault(p, p):
            self.parent[a] = self.parent[p]
            a, p = p, self.parent[p]
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_tracks(n_frames: int,
                 matches: Dict[Tuple[int, int], np.ndarray]
                 ) -> List[Dict[int, int]]:
    """Union-find feature tracks.

    matches[(i, j)] is an (M, 2) int array of (kpt_i, kpt_j) pairs.
    Returns a list of tracks, each {frame: kpt_index}; tracks with
    conflicting observations (two kpts of one frame) are dropped.
    """
    uf = _UnionFind()
    for (i, j), m in matches.items():
        for a, b in np.asarray(m):
            uf.union((i, int(a)), (j, int(b)))
    groups: Dict = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)
    tracks = []
    for nodes in groups.values():
        if len(nodes) < 2:
            continue
        track: Dict[int, int] = {}
        ok = True
        for f, k in nodes:
            if f in track and track[f] != k:
                ok = False      # merged-track conflict: discard
                break
            track[f] = k
        if ok and len(track) >= 2:
            tracks.append(track)
    return tracks


class _ObsTable:
    """Flat observation table: one row per (track, frame) observation,
    sorted by key = track * n_frames + frame so any batch of
    (track, frame) lookups is a vectorized searchsorted. Pruning flips
    `alive` — rows are never deleted, keeping the sort key valid for
    the whole reconstruction."""

    def __init__(self, tracks: List[Dict[int, int]],
                 kp_xy: Sequence[np.ndarray], n_frames: int):
        trk, frm, kpt = [], [], []
        for ti, tr in enumerate(tracks):
            for f, k in tr.items():
                trk.append(ti)
                frm.append(f)
                kpt.append(k)
        trk = np.asarray(trk, np.int64)
        frm = np.asarray(frm, np.int64)
        kpt = np.asarray(kpt, np.int64)
        order = np.argsort(trk * n_frames + frm)
        self.n_frames = n_frames
        self.n_tracks = len(tracks)
        self.track = trk[order].astype(np.int32)
        self.frame = frm[order].astype(np.int32)
        self.kpt = kpt[order].astype(np.int32)
        self.key = (self.track.astype(np.int64) * n_frames
                    + self.frame)
        self.uv = np.zeros((len(self.frame), 2), np.float32)
        for f in np.unique(self.frame):          # O(F) vectorized gathers
            rows = self.frame == f
            self.uv[rows] = np.asarray(kp_xy[f],
                                       np.float32)[self.kpt[rows]]
        self.alive = np.ones(len(self.track), bool)

    def lookup(self, t: np.ndarray, f) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized (track, frame) -> (row index, found & alive)."""
        q = np.asarray(t, np.int64) * self.n_frames + np.asarray(f)
        pos = np.searchsorted(self.key, q)
        pos = np.minimum(pos, max(len(self.key) - 1, 0))
        ok = (self.key[pos] == q) & self.alive[pos] \
            if len(self.key) else np.zeros(len(q), bool)
        return pos, ok

    def tracks_as_dicts(self) -> List[Dict[int, int]]:
        """Alive observations back as {frame: kpt} dicts (export /
        compatibility view; O(O) once at the end)."""
        out: List[Dict[int, int]] = [dict() for _ in range(self.n_tracks)]
        for t, f, k in zip(self.track[self.alive],
                           self.frame[self.alive],
                           self.kpt[self.alive]):
            out[t][int(f)] = int(k)
        return out


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Batched NumPy Rodrigues: (F, 3) -> (F, 3, 3). Host twin of
    lie.so3_exp for the driver's bulk bookkeeping passes (pruning /
    retriangulation touch every frame every call; small per-frame
    device round trips would dominate them)."""
    w = np.asarray(w, np.float64)
    theta2 = np.einsum("fi,fi->f", w, w)
    theta = np.sqrt(theta2 + 1e-16)
    t2s = np.maximum(theta2, 1e-16)
    a = np.where(theta2 > 1e-16, np.sin(theta) / theta,
                 1.0 - theta2 / 6.0)
    b = np.where(theta2 > 1e-16, (1.0 - np.cos(theta)) / t2s,
                 0.5 - theta2 / 24.0)
    z = np.zeros_like(w[:, 0])
    k = np.stack([
        np.stack([z, -w[:, 2], w[:, 1]], -1),
        np.stack([w[:, 2], z, -w[:, 0]], -1),
        np.stack([-w[:, 1], w[:, 0], z], -1),
    ], 1)
    kk = np.einsum("fij,fjk->fik", k, k)
    return (np.eye(3)[None] + a[:, None, None] * k
            + b[:, None, None] * kk)


@dataclasses.dataclass
class Reconstruction:
    """Result of incremental SfM (NumPy, host-side)."""
    cameras: np.ndarray          # (F, 6) [w|t], world->cam
    registered: np.ndarray       # (F,) bool
    points: np.ndarray           # (T, 3) one slot per track
    has_point: np.ndarray        # (T,) bool
    tracks: List[Dict[int, int]]
    reproj_rmse: float


def _ba_tables(table: _ObsTable, cameras, registered, points, has_point,
               obs_cap: Optional[int] = None,
               anchor_frame: Optional[int] = None,
               free_frames: Optional[np.ndarray] = None):
    """Flatten the current map into a static BAProblem (one vectorized
    pass over the observation table).

    Only observations of registered cameras with finite parameters are
    included (a camera whose registration failed must not contribute
    NaN residuals). ``anchor_frame`` is additionally marked fixed to
    pin the 6-dof gauge; without it no registered camera is fixed and
    only LM damping regularizes the singular Schur system.

    ``free_frames`` (bool (F,)) restricts the problem to a LOCAL
    window: only cameras in the window move, and only tracks observed
    by a window camera enter the table (other cameras observing those
    tracks stay as fixed anchors) — incremental cost stays bounded
    by the window, not the map.

    Capacities (observation count, live-point count) are padded to
    powers of two so bundle_adjust compiles once per ladder step, not
    once per call. Observation-less padded points receive bp=0 and
    dp=0 in the LM step (sfm/ba.py) and are returned untouched.
    """
    finite_cam = np.isfinite(cameras).all(axis=1)
    usable = registered & finite_cam
    obs_ok = table.alive & usable[table.frame] & has_point[table.track]
    if free_frames is not None:
        touched = np.zeros(table.n_tracks, bool)
        touched[table.track[obs_ok & free_frames[table.frame]]] = True
        live_mask = has_point & touched
    else:
        live_mask = has_point
    sel = obs_ok & live_mask[table.track]
    live = np.where(live_mask)[0]
    remap = np.zeros(table.n_tracks, np.int64)
    remap[live] = np.arange(len(live))
    cam_idx = table.frame[sel].astype(np.int64)
    pt_idx = remap[table.track[sel]]
    uv = table.uv[sel]

    o = len(cam_idx)
    cap = obs_cap or _pow2(o, lo=64)
    pad = cap - o
    mask = np.zeros(cap, bool)
    mask[:o] = True
    fixed = ~usable
    if free_frames is not None:
        fixed = fixed | ~free_frames
    if anchor_frame is not None:
        fixed = fixed.copy()
        fixed[anchor_frame] = True
    # non-finite (failed) cameras are fixed + observation-free, but
    # zero their params so fixed-slot arithmetic stays NaN-free
    safe_cameras = np.where(finite_cam[:, None], cameras, 0.0)
    pt_cap = _pow2(len(live), lo=32)
    pts = np.zeros((pt_cap, 3), points.dtype)
    pts[:len(live)] = points[live]
    from sift_tpu.utils.logger import COUNTERS
    COUNTERS.inc(f"ba_shape/{cap}x{pt_cap}")
    prob = BAProblem(
        cameras=jnp.asarray(safe_cameras, jnp.float32),
        points=jnp.asarray(pts, jnp.float32),
        cam_idx=jnp.asarray(np.concatenate(
            [cam_idx, np.zeros(pad, np.int64)]).astype(np.int32)),
        pt_idx=jnp.asarray(np.concatenate(
            [pt_idx, np.zeros(pad, np.int64)]).astype(np.int32)),
        uv=jnp.asarray(np.concatenate(
            [uv, np.zeros((pad, 2), np.float32)]).astype(np.float32)),
        mask=jnp.asarray(mask),
        fixed_cams=jnp.asarray(fixed))
    return prob, live


def _pose_rt(cam6):
    r = np.asarray(lie.so3_exp(jnp.asarray(cam6[:3], jnp.float32)))
    return r, np.asarray(cam6[3:], np.float64)


def reconstruct(kp_xy: Sequence[np.ndarray],
                matches: Dict[Tuple[int, int], np.ndarray],
                init_pair: Optional[Tuple[int, int]] = None,
                ransac_threshold: float = 2e-3,
                ba_every: int = 3,
                ba_iters: int = 12,
                min_pnp_points: int = 12,
                cap_pad: int = 256,
                ba_window: Optional[int] = 8,
                retriangulate_every: int = 2,
                prune_factor: float = 4.0) -> Reconstruction:
    """Run incremental SfM.

    kp_xy: per-frame (N_f, 2) NORMALIZED keypoint coordinates.
    matches: {(i, j): (M, 2) keypoint index pairs}, i < j.
    ba_window: periodic BA optimizes only the last `ba_window`
        registered frames (plus their tracks) — bounded incremental
        cost; None = global. The final BA is always global.
    retriangulate_every: refresh live points from all their registered
        rays (multi-view midpoint) every N-th periodic BA (0 disables).
    prune_factor: after each BA, drop observations with reprojection
        error > prune_factor * ransac_threshold (COLMAP-style track
        filtering; 0 disables).
    """
    n_frames = len(kp_xy)
    tracks = build_tracks(n_frames, matches)
    table = _ObsTable(tracks, kp_xy, n_frames)
    n_tracks = table.n_tracks
    cameras = np.zeros((n_frames, 6), np.float64)
    registered = np.zeros(n_frames, bool)
    failed = np.zeros(n_frames, bool)   # PnP-rejected views: never BA'd
    points = np.zeros((n_tracks, 3), np.float64)
    has_point = np.zeros(n_tracks, bool)

    def usable_frames():
        return registered & np.isfinite(cameras).all(axis=1)

    # pad two-view correspondences to a static capacity
    def pad2(a, cap):
        out = np.zeros((cap, a.shape[1]), np.float32)
        out[:len(a)] = a
        m = np.zeros(cap, bool)
        m[:len(a)] = True
        return out, m

    # triangulate tracks between two registered frames; returns the
    # number of accepted (cheirality-positive, finite) points.
    # Batches are padded to powers of two so `triangulate` compiles
    # once per ladder step, not once per batch size.
    def tri_tracks(track_ids, fa, fb) -> int:
        track_ids = np.asarray(track_ids, np.int64)
        ra, ta = _pose_rt(cameras[fa])
        rb, tb = _pose_rt(cameras[fb])
        ia, oka = table.lookup(track_ids, fa)
        ib, okb = table.lookup(track_ids, fb)
        keep = oka & okb
        track_ids, ia, ib = track_ids[keep], ia[keep], ib[keep]
        if not len(track_ids):
            return 0
        pa, pb = table.uv[ia], table.uv[ib]
        n = len(track_ids)
        cap = _pow2(n, lo=16)
        pa_p = np.zeros((cap, 2), np.float32)
        pb_p = np.zeros((cap, 2), np.float32)
        pa_p[:n], pb_p[:n] = pa, pb
        x = np.asarray(triangulate(
            jnp.asarray(ra, jnp.float32), jnp.asarray(ta, jnp.float32),
            jnp.asarray(rb, jnp.float32), jnp.asarray(tb, jnp.float32),
            jnp.asarray(pa_p), jnp.asarray(pb_p)))[:n]
        za = (x @ ra.T + ta)[:, 2]
        zb = (x @ rb.T + tb)[:, 2]
        good = (za > 1e-3) & (zb > 1e-3) & np.isfinite(x).all(axis=1)
        points[track_ids[good]] = x[good]
        has_point[track_ids[good]] = True
        return int(good.sum())

    def retriangulate():
        """Refresh every live point from ALL its registered rays in one
        vectorized multi-view midpoint pass: per observation the ray
        (camera center, world direction), per track the 3x3 normal
        system sum_o (I - d d^T) x = sum_o (I - d d^T) c accumulated
        with bincount segment sums. Early two-view triangulations
        improve as later registrations widen each track's baseline;
        using all rays (not just the widest pair) both conditions the
        refresh better and removes the old per-track O(F^2)
        widest-pair scans."""
        usable = usable_frames()
        sel = table.alive & usable[table.frame] & has_point[table.track]
        idx = np.where(sel)[0]
        if not len(idx):
            return
        f = table.frame[idx].astype(np.int64)
        t = table.track[idx].astype(np.int64)
        rw = _so3_exp_np(cameras[:, :3])          # (F, 3, 3)
        centers = -np.einsum("fij,fi->fj", rw, cameras[:, 3:])
        d_cam = np.concatenate(
            [table.uv[idx].astype(np.float64),
             np.ones((len(idx), 1))], 1)
        d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
        d = np.einsum("oij,oi->oj", rw[f], d_cam)  # world directions
        m = np.eye(3)[None] - d[:, :, None] * d[:, None, :]  # (O,3,3)
        mc = np.einsum("oij,oj->oi", m, centers[f])
        a9 = np.stack(
            [np.bincount(t, weights=m[:, i, j], minlength=n_tracks)
             for i in range(3) for j in range(3)], 1)
        b3 = np.stack(
            [np.bincount(t, weights=mc[:, i], minlength=n_tracks)
             for i in range(3)], 1)
        cnt = np.bincount(t, minlength=n_tracks)
        live = np.where((cnt >= 2) & has_point)[0]
        if not len(live):
            return
        a = a9[live].reshape(-1, 3, 3)
        det = np.linalg.det(a)
        solvable = np.abs(det) > 1e-9
        x = np.zeros((len(live), 3))
        if solvable.any():
            x[solvable] = np.linalg.solve(
                a[solvable], b3[live][solvable][:, :, None])[:, :, 0]
        # cheirality over every contributing ray: a track is refreshed
        # only if ALL its registered observations see the new point in
        # front of the camera
        remap = np.full(n_tracks, -1, np.int64)
        remap[live] = np.arange(len(live))
        z = (np.einsum("oij,oj->oi", rw[f], x[remap[t]])
             + cameras[f, 3:])[:, 2]
        n_behind = np.bincount(t, weights=(z <= 1e-3).astype(np.float64),
                               minlength=n_tracks)[live]
        ok = solvable & (n_behind == 0) & np.isfinite(x).all(axis=1)
        points[live[ok]] = x[ok]

    def prune_observations(max_err: float) -> int:
        """COLMAP-style track filtering: drop observations whose
        reprojection error exceeds max_err (wrong-correspondence
        matches poison BA long before robust losses saturate); tracks
        left with <2 registered views lose their point. One vectorized
        pass over the observation table; returns the number of
        observations removed."""
        usable = usable_frames()
        sel = table.alive & usable[table.frame] & has_point[table.track]
        idx = np.where(sel)[0]
        if not len(idx):
            return 0
        f = table.frame[idx].astype(np.int64)
        t = table.track[idx].astype(np.int64)
        rw = _so3_exp_np(cameras[:, :3])
        xc = (np.einsum("oij,oj->oi", rw[f], points[t])
              + cameras[f, 3:])
        z = xc[:, 2]
        err = np.linalg.norm(
            xc[:, :2] / np.maximum(z, 1e-12)[:, None]
            - table.uv[idx], axis=1)
        bad = (z <= 1e-6) | (err > max_err)
        table.alive[idx[bad]] = False
        alive_reg = table.alive & registered[table.frame]
        cnt_reg = np.bincount(table.track[alive_reg],
                              minlength=n_tracks)
        cnt_all = np.bincount(table.track[table.alive],
                              minlength=n_tracks)
        has_point[(cnt_all < 2) | (cnt_reg < 2)] = False
        return int(bad.sum())

    # --- initialization: try pairs by match count until one yields a
    # well-conditioned baseline (near-pure-rotation pairs triangulate
    # nothing and are rejected by cheirality) ---
    candidates = ([init_pair] if init_pair is not None else
                  sorted(matches, key=lambda k: -len(matches[k])))
    init_done = False
    for (i0, j0) in candidates:
        m0 = np.asarray(matches[(i0, j0)])
        if len(m0) < 16:
            continue
        cap = _pow2(len(m0), lo=16) * 2
        p0, mask0 = pad2(kp_xy[i0][m0[:, 0]], cap)
        p1, _ = pad2(kp_xy[j0][m0[:, 1]], cap)
        res = find_essential_ransac(jnp.asarray(p0), jnp.asarray(p1),
                                    valid=jnp.asarray(mask0),
                                    threshold=ransac_threshold)
        if not bool(np.asarray(res.ok)):
            continue
        cameras[j0, :3] = np.asarray(lie.so3_log(res.R))
        cameras[j0, 3:] = np.asarray(res.t)
        registered[i0] = registered[j0] = True
        # tracks observed in BOTH init frames (vectorized lookups)
        all_t = np.arange(n_tracks, dtype=np.int64)
        _, in_i0 = table.lookup(all_t, i0)
        _, in_j0 = table.lookup(all_t, j0)
        init_tracks = all_t[in_i0 & in_j0]
        n_ok = tri_tracks(init_tracks, i0, j0) if len(init_tracks) else 0
        if n_ok >= min_pnp_points:
            init_done = True
            break
        # degenerate baseline: roll back and try the next pair
        registered[i0] = registered[j0] = False
        cameras[j0] = 0.0
        points[:] = 0.0
        has_point[:] = False
    if not init_done:
        raise RuntimeError(
            "two-view initialization failed: no pair with a usable "
            "baseline (all candidate pairs near-degenerate, e.g. pure "
            "rotation, or too few matches)")

    # --- incremental registration ---
    n_since_ba = 0
    n_bas = 0
    reg_order: List[int] = [i0, j0]
    while True:
        # candidate view with largest 2D-3D overlap (one bincount)
        cand = (table.alive & has_point[table.track]
                & ~registered[table.frame] & ~failed[table.frame])
        counts = np.bincount(table.frame[cand], minlength=n_frames)
        best_f = int(counts.argmax())
        best_overlap = int(counts[best_f])
        if best_overlap < min_pnp_points:
            break

        rows = cand & (table.frame == best_f)
        ts = table.track[rows].astype(np.int64)
        x3 = points[ts]
        p2 = table.uv[rows]
        cap = _pow2(len(ts), lo=16) * 2
        x3p, maskp = pad2(x3, cap)
        p2p, _ = pad2(p2, cap)
        pres = pnp_ransac(jnp.asarray(x3p), jnp.asarray(p2p),
                          valid=jnp.asarray(maskp),
                          threshold=ransac_threshold)
        if not bool(np.asarray(pres.ok)) or \
                int(np.asarray(pres.n_inliers)) < min_pnp_points // 2:
            # cannot register this view; blacklist it (NOT registered,
            # so its observations never enter BA) to avoid re-trying
            failed[best_f] = True
            continue
        registered[best_f] = True
        reg_order.append(best_f)
        cameras[best_f, :3] = np.asarray(lie.so3_log(pres.R))
        cameras[best_f, 3:] = np.asarray(pres.t)

        # triangulate new tracks now visible from >= 2 registered
        # views: per-track first/last registered frame via segment
        # min/max over the table, grouped by frame pair
        usable = usable_frames()
        reg_obs = table.alive & usable[table.frame]
        cnt = np.bincount(table.track[reg_obs], minlength=n_tracks)
        new_mask = ~has_point & (cnt >= 2)
        sel = reg_obs & new_mask[table.track]
        if sel.any():
            tsel = table.track[sel].astype(np.int64)
            fsel = table.frame[sel].astype(np.int64)
            fa = np.full(n_tracks, n_frames, np.int64)
            fb = np.full(n_tracks, -1, np.int64)
            np.minimum.at(fa, tsel, fsel)
            np.maximum.at(fb, tsel, fsel)
            new_t = np.where(new_mask)[0]
            pair_key = fa[new_t] * n_frames + fb[new_t]
            for key in np.unique(pair_key):
                grp = new_t[pair_key == key]
                tri_tracks(grp, int(key // n_frames),
                           int(key % n_frames))

        n_since_ba += 1
        if n_since_ba >= ba_every and has_point.any():
            n_since_ba = 0
            n_bas += 1
            if retriangulate_every and n_bas % retriangulate_every == 0:
                retriangulate()
            free = None
            if ba_window is not None:
                free = np.zeros(n_frames, bool)
                free[reg_order[-ba_window:]] = True
            prob, live = _ba_tables(table, cameras, registered,
                                    points, has_point, anchor_frame=i0,
                                    free_frames=free)
            out = bundle_adjust(prob, iters=ba_iters, loss="cauchy",
                                huber_delta=ransac_threshold)
            cameras[registered] = np.asarray(out.cameras)[registered]
            points[live] = np.asarray(out.points)[:len(live)]
            if prune_factor:
                prune_observations(prune_factor * ransac_threshold)

    # --- final BA (always global) ---
    if not has_point.any():
        raise RuntimeError("reconstruction has no 3-D points")
    if retriangulate_every:
        retriangulate()
    prob, live = _ba_tables(table, cameras, registered,
                            points, has_point, anchor_frame=i0)
    out = bundle_adjust(prob, iters=ba_iters * 2, loss="cauchy",
                        huber_delta=ransac_threshold)
    cameras[registered] = np.asarray(out.cameras)[registered]
    points[live] = np.asarray(out.points)[:len(live)]
    if prune_factor and prune_observations(
            prune_factor * ransac_threshold) and has_point.any():
        # contaminated observations left the table: one more clean BA
        prob, live = _ba_tables(table, cameras, registered,
                                points, has_point, anchor_frame=i0)
        out = bundle_adjust(prob, iters=ba_iters, loss="cauchy",
                            huber_delta=ransac_threshold)
        cameras[registered] = np.asarray(out.cameras)[registered]
        points[live] = np.asarray(out.points)[:len(live)]
    rmse = float(np.asarray(reproj_rmse(out)))

    cameras[failed] = np.nan        # mark unregisterable views clearly
    return Reconstruction(cameras=cameras, registered=registered,
                          points=points, has_point=has_point,
                          tracks=table.tracks_as_dicts(),
                          reproj_rmse=rmse)
