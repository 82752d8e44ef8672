"""Phases of the one-card smoke run (chip_smoke.py) and of the GPU test
lane (tests/test_gpu.py), as functions that take their sizes.

Each phase drives the real entry points, checks its results against a
plain reference, raises SmokeFailure on any miss and returns the
numbers it measured. The same functions run here on the CPU at tiny
sizes (tests/test_smoke.py), so their control flow is tested without
a card; only a run on the card says anything about the card.

Tolerances, each with its reason, are module constants below.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# --- tolerances -----------------------------------------------------
# Detected object corners vs the homography that placed the object.
CORNER_TOL_PX = 3.0
# Keypoints of one image on two backends: the same jitted program, so
# a keypoint moves only through float32 summation order (blur taps,
# reductions) — far below 1e-3 px.
KP_POS_TOL_PX = 1e-3
# Orientation of twin keypoints: the histogram sums in another order.
KP_ANGLE_TOL_DEG = 0.01
# Share of keypoints that must find their twin: a keypoint whose
# contrast/edge/peak test sits within rounding of its threshold can
# flip between backends.
KP_PAIRED_MIN = 0.99
# Per-keypoint descriptor L1 distance between backends (descriptors
# have unit sum of squares; true matches sit at L1 ~2-4). Summation
# order moves the bf16 one-hot contraction's f32 accumulator by
# ~1e-6, and a value on a rint() boundary of the uchar quantisation
# step (src/sift.cpp:710) moves one element by ~0.01.
DESC_L1_MEDIAN_TOL = 0.01
DESC_L1_P99_TOL = 0.1
# Ratio-test decisions that must agree between backends.
RATIO_AGREE_MIN = 0.99
# Keypoint recall vs the NumPy oracle twin (tests/test_detect.py).
ORACLE_RECALL_MIN = 0.97
# RANSAC + refinement vs a float64 NumPy DLT + Gauss-Newton on the
# same inlier set: corner transfer over an 800 px square. float32
# rounding alone leaves 5e-5 to 1.1e-4 px, depending on the seed; the
# limit is 18x the largest. Unpinned products (TF32 allowed) read
# 9.6e-5 px on an H100, inside that spread, so this check cannot tell
# them apart: tests/test_precision.py checks the pin itself.
HOMOGRAPHY_CORNER_TOL_PX = 2e-3
# BA on the card vs the same solve on the CPU backend: final RMS
# reprojection error (normalized coords; observation noise 1e-3)
# within 0.1% and cameras within 1e-4. Pinned runs on an H100 read
# equal RMSE to seven digits and cameras within 4e-6 to 1e-5; unpinned,
# 2.1e-5.
BA_RMSE_RTOL = 1e-3
BA_CAM_TOL = 1e-4


class SmokeFailure(AssertionError):
    """A smoke phase's result missed its reference."""


def check(ok, what: str) -> None:
    if not bool(ok):
        raise SmokeFailure(what)


def log(msg: str) -> None:
    """Progress on stderr, so a slow step is named in a cut run."""
    print(f"[smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


@contextlib.contextmanager
def _step(seconds: Dict[str, float], name: str):
    """Log a sub-step's start and record its wall seconds, compilation
    included, under `name`."""
    log(name)
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0


def _timed(fn, n: int) -> Dict[str, float]:
    """Median / p90 wall ms over n calls, each ended by
    block_until_ready."""
    import jax
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ts)),
            "p90_ms": float(np.percentile(ts, 90)), "n": n}


# --- phase 1: device ------------------------------------------------

def phase_device(platform: str = "gpu") -> dict:
    """Fail unless JAX's default device is on `platform`."""
    import jax
    from sift_tpu.utils.device import device_stamp
    stamp = device_stamp()
    check(jax.devices()[0].platform == platform,
          f"default device {jax.devices()[0]} is not on {platform!r}")
    return stamp


# --- phase 2: the demo pipeline at full size ------------------------

def phase_pipeline(scene_hw=(1080, 1920), obj_hw=(240, 320), seed=0,
                   n_warm: int = 20,
                   kp_range: Tuple[int, int] = (200, 5000)) -> dict:
    """pipeline.detect_object on a seeded planar scene with DEFAULT_CONFIG:
    found, corners within CORNER_TOL_PX of the truth, no candidate cap
    saturated, a natural keypoint count; compile and warm latency."""
    import jax
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops import pyramid as pyr
    from sift_tpu.pipeline import detect_object

    ps = synth.planar_scene(scene_hw, obj_hw, seed=seed)
    scene = jax.device_put(ps.scene)
    obj = jax.device_put(ps.object)

    t0 = time.perf_counter()
    det = jax.block_until_ready(detect_object(scene, obj, CFG))
    compile_s = time.perf_counter() - t0

    err = float(np.abs(np.asarray(det.corners) - ps.corners).max())
    n_scene = int(det.scene_kp.count())
    n_obj = int(det.object_kp.count())
    cand_sat = [np.asarray(sift.candidate_saturation(
        pyr.build_gaussian_pyramid(img, CFG), CFG)).tolist()
        for img in (scene, obj)]
    out_sat = [np.asarray(sift.octave_saturation(kp, CFG)).tolist()
               for kp in (det.scene_kp, det.object_kp)]
    out = {"scene_hw": list(scene_hw), "obj_hw": list(obj_hw),
           "found": bool(det.found), "corner_err_px": err,
           "n_inliers": int(det.n_inliers),
           "good_matches": int(np.asarray(det.matches.good).sum()),
           "scene_keypoints": n_scene, "object_keypoints": n_obj,
           "candidate_saturation": cand_sat,
           "octave_saturation": out_sat,
           "compile_plus_first_call_s": compile_s}
    check(out["found"], f"object not found: {out}")
    check(err <= CORNER_TOL_PX,
          f"corners {err:.3f} px from the truth (> {CORNER_TOL_PX})")
    check(not any(any(s) for s in cand_sat),
          f"candidate caps saturated: {cand_sat}")
    check(kp_range[0] <= n_scene <= kp_range[1],
          f"scene keypoints {n_scene} outside {kp_range}")

    log("pipeline: warm latency")
    out["latency"] = _timed(lambda: detect_object(scene, obj, CFG), n_warm)
    ma = sift.detect_and_compute.lower(scene, CFG).compile() \
        .memory_analysis()
    out["detect_and_compute_memory"] = _memory_dict(ma)
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def _memory_dict(ma) -> Optional[dict]:
    if ma is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


# --- phase 3: parity vs the plain reference -------------------------

def _pair_points(a: np.ndarray, b: np.ndarray, tol: float,
                 ang_tol: float = KP_ANGLE_TOL_DEG) -> np.ndarray:
    """For each row of a (N, 3) [x, y, angle], the index of the nearest
    row of b within tol px (Chebyshev on x, y) and ang_tol degrees,
    else -1. Angle matters: orientation peaks put several keypoints on
    one position."""
    if len(a) == 0 or len(b) == 0:
        return np.full(len(a), -1)
    d = np.abs(a[:, None, :2] - b[None, :, :2]).max(-1)
    da = np.abs(a[:, None, 2] - b[None, :, 2]) % 360.0
    da = np.minimum(da, 360.0 - da)
    cost = np.where((d <= tol) & (da <= ang_tol), d + 1e-3 * da, np.inf)
    j = cost.argmin(1)
    return np.where(np.isfinite(cost[np.arange(len(a)), j]), j, -1)


def _valid_xy(kp) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(kp.valid)
    idx = np.where(v)[0]
    xy = np.stack([np.asarray(kp.x)[idx], np.asarray(kp.y)[idx],
                   np.asarray(kp.angle)[idx]], 1)
    return idx, xy.astype(np.float64)


def phase_parity(scene_hw=(960, 960), obj_hw=(240, 320), seed=1,
                 oracle_hw=(256, 256)) -> dict:
    """The same jitted detect_and_compute on the default device and on
    the CPU backend of this process (the demo's own 960x960 scene and
    the object), then the default device vs the NumPy oracle twin at
    oracle_hw."""
    import jax
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops.match import match_ratio

    cpu = jax.devices("cpu")[0]
    acc = jax.devices()[0]
    ps = synth.planar_scene(scene_hw, obj_hw, seed=seed)
    res = {}
    for name, dev in (("acc", acc), ("cpu", cpu)):
        log(f"parity: detect_and_compute + match on {dev}")
        s = jax.device_put(ps.scene, dev)
        o = jax.device_put(ps.object, dev)
        kps, ds = sift.detect_and_compute(s, CFG)
        kpo, do = sift.detect_and_compute(o, CFG)
        m = match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid,
                        ratio=CFG.match_ratio)
        res[name] = jax.device_get((kps, ds, kpo, do, m))

    out = {"scene_hw": list(scene_hw), "obj_hw": list(obj_hw)}
    l1_all = []
    pairs = {}
    for role, ki, di in (("scene", 0, 1), ("object", 2, 3)):
        ia, xya = _valid_xy(res["acc"][ki])
        ic, xyc = _valid_xy(res["cpu"][ki])
        j = _pair_points(xya, xyc, KP_POS_TOL_PX)
        back = _pair_points(xyc, xya, KP_POS_TOL_PX)
        paired = min((j >= 0).mean() if len(j) else 1.0,
                     (back >= 0).mean() if len(back) else 1.0)
        # slot-level map acc slot -> cpu slot
        slot = np.full(len(np.asarray(res["acc"][ki].valid)), -1)
        slot[ia[j >= 0]] = ic[j[j >= 0]]
        pairs[role] = slot
        da = np.asarray(res["acc"][di])[ia[j >= 0]]
        dc = np.asarray(res["cpu"][di])[ic[j[j >= 0]]]
        l1 = np.abs(da - dc).sum(1)
        l1_all.append(l1)
        out[f"{role}_keypoints"] = [len(ia), len(ic)]
        out[f"{role}_paired_frac"] = float(paired)
        check(len(ia) > 0, f"no {role} keypoints")
        check(paired >= KP_PAIRED_MIN,
              f"{role}: only {paired:.4f} of keypoints paired within "
              f"{KP_POS_TOL_PX} px")
    l1 = np.concatenate(l1_all)
    out["desc_l1_median"] = float(np.median(l1))
    out["desc_l1_p99"] = float(np.percentile(l1, 99))
    check(out["desc_l1_median"] <= DESC_L1_MEDIAN_TOL,
          f"descriptor L1 median {out['desc_l1_median']:.4g}")
    check(out["desc_l1_p99"] <= DESC_L1_P99_TOL,
          f"descriptor L1 p99 {out['desc_l1_p99']:.4g}")

    # ratio-test decisions per valid acc query, mapped through pairing
    ma, mc = res["acc"][4], res["cpu"][4]
    qv = np.where(np.asarray(res["acc"][2].valid))[0]
    qmap, tmap = pairs["object"], pairs["scene"]
    ga, gc = np.asarray(ma.good), np.asarray(mc.good)
    ta, tc = np.asarray(ma.train_idx), np.asarray(mc.train_idx)
    agree = []
    for q in qv:
        qc = qmap[q]
        if qc < 0:
            agree.append(False)
            continue
        same = ga[q] == gc[qc]
        if same and ga[q]:
            same = tmap[ta[q]] == tc[qc]
        agree.append(bool(same))
    out["ratio_agree_frac"] = float(np.mean(agree)) if agree else 1.0
    out["good_matches"] = [int(ga.sum()), int(gc.sum())]
    check(out["ratio_agree_frac"] >= RATIO_AGREE_MIN,
          f"ratio-test decisions agree on {out['ratio_agree_frac']:.4f}")

    log("parity: NumPy oracle")
    out["oracle"] = oracle_recall(oracle_hw, seed=seed)
    check(out["oracle"]["recall"] >= ORACLE_RECALL_MIN,
          f"oracle recall {out['oracle']['recall']:.4f}")
    return out


def oracle_recall(hw=(256, 256), seed=1) -> dict:
    """Keypoint recall of the default device vs the NumPy oracle
    (tests/test_detect.py's matching rule: position 0.1 px, size 1%,
    angle 1 degree)."""
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.oracle import cpu_sift as oracle

    img = synth.object_image(*hw, seed=seed + 101)
    kpts_ref, _ = oracle.sift_ncl(img, CFG)
    kp, _ = sift.detect_and_compute(img, CFG)
    jx, jy = np.asarray(kp.x), np.asarray(kp.y)
    jsz, jang = np.asarray(kp.size), np.asarray(kp.angle)
    jval = np.asarray(kp.valid)
    hits = 0
    for kr in kpts_ref:
        d = np.abs(jx - kr["x"]) + np.abs(jy - kr["y"])
        for i in np.where(jval & (d < 0.1))[0]:
            da = abs(jang[i] - kr["angle"])
            if (abs(jsz[i] - kr["size"]) <= 0.01 * kr["size"]
                    and min(da, 360 - da) <= 1.0):
                hits += 1
                break
    return {"hw": list(hw), "oracle_keypoints": len(kpts_ref),
            "recall": hits / max(len(kpts_ref), 1)}


# --- seeded inputs -------------------------------------------------

def random_descriptors(rng, n: int) -> np.ndarray:
    """sqrt-L1-normalized vectors with SIFT-like value distribution."""
    d = rng.random((n, 128)).astype(np.float32) ** 2
    d /= d.sum(axis=1, keepdims=True)
    return np.sqrt(d)


# --- phase 4: geometry / BA precision -------------------------------

def homography_case(rng, n=512, inlier_frac=0.7, noise=0.5):
    """Seeded correspondences under a known homography over an 800 px
    square: (H_true, src, dst)."""
    h_true = np.array([[1.1, 0.08, 30.0], [-0.05, 0.95, 12.0],
                       [2e-4, -1e-4, 1.0]])
    src = rng.uniform(0, 800, (n, 2))
    from sift_tpu.synth import project
    dst = project(h_true, src) + rng.normal(0, noise, (n, 2))
    n_out = int(n * (1 - inlier_frac))
    dst[:n_out] = rng.uniform(0, 800, (n_out, 2))
    return h_true, src.astype(np.float32), dst.astype(np.float32)


def _dlt64(src, dst):
    """Normalized DLT + Gauss-Newton on the transfer error, float64."""
    def norm(p):
        m = p.mean(0)
        s = np.sqrt(2) / np.mean(np.linalg.norm(p - m, axis=1))
        return np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1]])

    from sift_tpu.synth import project
    ts, td = norm(src), norm(dst)
    sh, dh = project(ts, src), project(td, dst)
    x, y, u, v = sh[:, 0], sh[:, 1], dh[:, 0], dh[:, 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    a = np.concatenate([np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], 1),
                        np.stack([z, z, z, x, y, o, -v * x, -v * y, -v], 1)])
    h = np.linalg.svd(a)[2][-1].reshape(3, 3)
    h = np.linalg.solve(td, h @ ts)
    h = h / h[2, 2]
    h8 = np.concatenate([h[0], h[1], h[2, :2]])
    for _ in range(20):
        d = h8[6] * src[:, 0] + h8[7] * src[:, 1] + 1.0
        px = (h8[0] * src[:, 0] + h8[1] * src[:, 1] + h8[2]) / d
        py = (h8[3] * src[:, 0] + h8[4] * src[:, 1] + h8[5]) / d
        r = np.concatenate([px - dst[:, 0], py - dst[:, 1]])
        sx, sy = src[:, 0], src[:, 1]
        zz = np.zeros_like(sx)
        jx = np.stack([sx / d, sy / d, 1 / d, zz, zz, zz,
                       -px * sx / d, -px * sy / d], 1)
        jy = np.stack([zz, zz, zz, sx / d, sy / d, 1 / d,
                       -py * sx / d, -py * sy / d], 1)
        j = np.concatenate([jx, jy])
        h8 = h8 - np.linalg.lstsq(j, r, rcond=None)[0]
    return np.concatenate([h8, [1.0]]).reshape(3, 3)


def ba_problem(rng, n_cams=50, n_pts=10000, views_per_pt=8,
               noise=1e-3):
    """Seeded BA problem: cameras on an arc looking at a point cloud,
    each point seen by `views_per_pt` cameras, perturbed start."""
    import jax.numpy as jnp
    from sift_tpu.sfm import BAProblem
    from scipy.spatial.transform import Rotation

    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 14, n_pts)], 1)
    w = np.zeros((n_cams, 3))
    w[:, 1] = np.linspace(-0.3, 0.3, n_cams)
    centers = np.stack([np.linspace(-3, 3, n_cams),
                        0.2 * np.sin(np.arange(n_cams)),
                        np.zeros(n_cams)], 1)
    rots = Rotation.from_rotvec(w).as_matrix()
    t = -np.einsum("cij,cj->ci", rots, centers)
    views_per_pt = min(views_per_pt, n_cams)
    cam_idx = np.argsort(rng.random((n_pts, n_cams)), axis=1)[
        :, :views_per_pt].reshape(-1)
    pt_idx = np.repeat(np.arange(n_pts), views_per_pt)
    xc = np.einsum("oij,oj->oi", rots[cam_idx], pts[pt_idx]) + t[cam_idx]
    uv = xc[:, :2] / xc[:, 2:3] + rng.normal(0, noise, (len(pt_idx), 2))
    cams = np.concatenate([w, t], 1)
    cams0 = cams.copy()
    cams0[1:] += rng.normal(0, 0.01, cams0[1:].shape)
    pts0 = pts + rng.normal(0, 0.03, pts.shape)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return BAProblem(
        cameras=jnp.asarray(cams0, jnp.float32),
        points=jnp.asarray(pts0, jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        pt_idx=jnp.asarray(pt_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        mask=jnp.ones(len(pt_idx), bool),
        fixed_cams=jnp.asarray(fixed))


def phase_precision(seed=3, n_corr=512, n_cams=50, n_pts=10000,
                    ba_iters: int = 20) -> dict:
    """find_homography_ransac vs a float64 NumPy DLT on its inlier set;
    bundle_adjust on the default device vs the CPU backend."""
    import jax
    from sift_tpu.geometry import (find_homography_ransac,
                                   perspective_transform)
    from sift_tpu.sfm import bundle_adjust, reproj_rmse

    rng = np.random.default_rng(seed)
    _, src, dst = homography_case(rng, n_corr)
    log("precision: homography RANSAC")
    res = jax.device_get(find_homography_ransac(jax.device_put(src),
                                                jax.device_put(dst)))
    inl = np.asarray(res.inliers)
    h64 = _dlt64(src[inl].astype(np.float64), dst[inl].astype(np.float64))
    sq = np.array([[0, 0], [800, 0], [800, 800], [0, 800]], np.float32)
    from sift_tpu.synth import project
    got = np.asarray(perspective_transform(sq, np.asarray(res.H)))
    want = project(h64, sq.astype(np.float64))
    out = {"homography": {"n_inliers": int(inl.sum()),
                          "corner_max_diff_px":
                              float(np.abs(got - want).max())}}
    check(bool(res.ok), "homography RANSAC found no model")
    check(out["homography"]["corner_max_diff_px"]
          <= HOMOGRAPHY_CORNER_TOL_PX,
          f"homography vs float64 DLT: {out['homography']}")

    prob = ba_problem(np.random.default_rng(seed + 1), n_cams, n_pts)
    cpu = jax.devices("cpu")[0]
    ba = {}
    for name, dev in (("acc", jax.devices()[0]), ("cpu", cpu)):
        log(f"precision: bundle_adjust on {dev}")
        p = jax.device_put(prob, dev)
        t0 = time.perf_counter()
        r = jax.block_until_ready(bundle_adjust(p, iters=ba_iters))
        ba[name] = (jax.device_get(r), float(reproj_rmse(r)),
                    time.perf_counter() - t0)
    cam_diff = float(np.abs(np.asarray(ba["acc"][0].cameras)
                            - np.asarray(ba["cpu"][0].cameras)).max())
    out["ba"] = {"observations": int(prob.mask.shape[0]),
                 "rmse_start": float(reproj_rmse(prob)),
                 "rmse_acc": ba["acc"][1], "rmse_cpu": ba["cpu"][1],
                 "cam_max_diff": cam_diff,
                 "acc_s_with_compile": ba["acc"][2],
                 "cpu_s_with_compile": ba["cpu"][2]}
    check(abs(ba["acc"][1] - ba["cpu"][1]) <= BA_RMSE_RTOL * ba["cpu"][1],
          f"BA rmse differs: {out['ba']}")
    check(cam_diff <= BA_CAM_TOL, f"BA cameras differ: {out['ba']}")
    return out


# --- phase 5: four cards --------------------------------------------

def _spans(arr, n: int) -> bool:
    return len(arr.sharding.device_set) == n


def phase_four_cards(n: int = 4, frame_hw=(1080, 1920), seed=4,
                     n_query=1536, n_train=1536, n_cams=50,
                     n_pts=10000) -> dict:
    """The multi-device paths users call, each against its one-device
    twin, on a 1-D mesh of n devices; every sharded output must span
    all n devices."""
    import jax
    import jax.numpy as jnp
    from sift_tpu import parallel, sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops.match import match_ratio
    from sift_tpu.sfm import bundle_adjust, reproj_rmse

    check(len(jax.devices()) >= n, f"need {n} devices")
    mesh = parallel.default_mesh(n)
    sec: Dict[str, float] = {}
    out = {"devices": n, "step_seconds": sec}

    frames = np.stack([synth.textured_image(*frame_hw, seed=seed + i)
                       for i in range(n)])
    with _step(sec, "batched_detect_and_compute"):
        kp_b, d_b = jax.block_until_ready(
            parallel.batched_detect_and_compute(jnp.asarray(frames), mesh,
                                                CFG))
    check(_spans(d_b, n), "batched descriptors not on all devices")
    l1 = []
    with _step(sec, "per-frame detect_and_compute"):
        for i in range(n):
            kp1, d1 = sift.detect_and_compute(jnp.asarray(frames[i]), CFG)
            v = np.asarray(kp1.valid)
            check((np.asarray(kp_b.valid)[i] == v).all(),
                  f"frame {i}: batched keypoint validity differs")
            l1.append(np.abs(np.asarray(d_b)[i][v]
                             - np.asarray(d1)[v]).sum(1))
    l1 = np.concatenate(l1)
    check(np.median(l1) <= DESC_L1_MEDIAN_TOL
          and np.percentile(l1, 99) <= DESC_L1_P99_TOL,
          f"batched descriptors differ: median L1 {np.median(l1):.4g}, "
          f"p99 {np.percentile(l1, 99):.4g}")
    out["batched_detect"] = {"frames": n,
                             "desc_l1_median": float(np.median(l1)),
                             "desc_l1_p99": float(np.percentile(l1, 99))}

    # descriptor slots at the per-pair shape, a quarter of them empty
    # (padding past the keypoint count), so the masks are exercised
    rng = np.random.default_rng(seed)
    q = jnp.asarray(random_descriptors(rng, n_query))
    t = jnp.asarray(random_descriptors(rng, n_train))
    qv = jnp.asarray(rng.random(n_query) < 0.75)
    tv = jnp.asarray(rng.random(n_train) < 0.75)
    with _step(sec, "one-device match_ratio"):
        ref = jax.device_get(match_ratio(q, t, q_valid=qv, t_valid=tv))
    for name, fn in (("query_sharded", parallel.sharded_match_ratio),
                     ("train_sharded",
                      parallel.sharded_match_ratio_train_sharded)):
        with _step(sec, f"{name} matching"):
            r = jax.block_until_ready(fn(q, t, mesh, q_valid=qv,
                                         t_valid=tv))
        check(_spans(r.good, n), f"{name}: output not on all devices")
        got = jax.device_get(r)
        agree = float(((np.asarray(got.good) == np.asarray(ref.good))
                       & (np.asarray(got.train_idx)
                          == np.asarray(ref.train_idx))).mean())
        check(agree == 1.0, f"{name} agrees on {agree}")
        out[name] = {"agree": agree}

    prob = ba_problem(np.random.default_rng(seed + 1), n_cams, n_pts)
    with _step(sec, "one-device bundle_adjust"):
        ref_ba = jax.device_get(bundle_adjust(prob))
    for name, fn in (("ba_obs_sharded", parallel.bundle_adjust_sharded),
                     ("ba_point_sharded",
                      parallel.bundle_adjust_point_sharded)):
        with _step(sec, name):
            r = jax.block_until_ready(fn(prob, mesh))
        check(_spans(r.cameras, n) and _spans(r.points, n),
              f"{name}: output not on all devices")
        diff = float(np.abs(np.asarray(r.cameras)
                            - np.asarray(ref_ba.cameras)).max())
        out[name] = {"rmse": float(reproj_rmse(r)),
                     "rmse_one_device": float(reproj_rmse(ref_ba)),
                     "cam_max_diff": diff}
        check(diff <= 1e-3, f"{name}: {out[name]}")

    img = jnp.asarray(frames[0])
    with _step(sec, "detect_and_compute_tiled"):
        kp_t, d_t = jax.block_until_ready(
            parallel.detect_and_compute_tiled(img, mesh, CFG))
    check(_spans(d_t, n) and _spans(kp_t.x, n),
          "tiled detect: output not on all devices")
    kp_s, d_s = sift.detect_and_compute(img, CFG)
    vt, vs = np.asarray(kp_t.valid), np.asarray(kp_s.valid)
    _, xt = _valid_xy(kp_t)
    _, xs = _valid_xy(kp_s)
    j = _pair_points(xs, xt, KP_POS_TOL_PX)
    out["tiled_detect"] = {"keypoints": [int(vt.sum()), int(vs.sum())],
                           "paired_frac": float((j >= 0).mean())}
    check(out["tiled_detect"]["paired_frac"] >= KP_PAIRED_MIN,
          f"tiled detect: {out['tiled_detect']}")
    return out
