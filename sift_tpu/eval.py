"""Batch evaluation harness (BASELINE.json configs 2-3).

Replaces the reference's eyeball-the-drawMatches QA (SURVEY.md §4)
with measured gates:

  * synthetic-warp repeatability: each evaluated image is warped by a
    KNOWN homography (rotation + scale + perspective); keypoint
    repeatability and match precision are measured against the exact
    ground truth.
  * pair matching: object/scene pairs from the corpus through the full
    detect+describe+match+RANSAC pipeline; reports keypoints, good
    matches, inlier counts.

Usage:
    python -m sift_tpu.eval [--data /root/reference/data]
                            [--out report.json] [--max-side 640]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

from sift_tpu import io as sio
from sift_tpu import sift
from sift_tpu.config import DEFAULT_CONFIG
from sift_tpu.geometry import find_homography_ransac
from sift_tpu.ops.match import match_ratio
from sift_tpu.utils.metrics import (correspondence_recall,
                                    keypoint_recall,
                                    keypoint_repeatability)

# (scene, object) demo pairs present in the reference corpus
PAIRS = [("scene.jpg", "book.jpg"),
         ("base.jpg", "query.png"),
         ("adidas.jpg", "query2.png")]

# golden dumps from the COMPILED reference (tools/ref_dump): the
# >=0.95 keypoint/match recall acceptance gate is measured vs these
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "tests",
                      "golden", "ref_dump.npz")

# gates asserted by --gate (and the default CI artifact):
# recall thresholds are the BASELINE.json north-star numbers
GATES = {
    "min_keypoint_recall": 0.95,
    "min_match_recall": 0.95,
    "min_mean_repeatability": 0.60,
    "min_mean_match_precision": 0.85,
    # adidas/query2 yields only 2 good matches for the REFERENCE
    # itself (golden dump) — a homography (4 pts) is unfindable there
    # for any faithful implementation, so the gate is 2 of 3 pairs
    "min_pairs_found": 2,
    # config-5 end-to-end mapping (rendered procedural-texture loop,
    # ground-truth poses; sfm/mapping.py): trajectory radius is 0.9
    # world units, so 0.07 ATE is < 8% of it
    "mapping_min_registered_frac": 0.9,
    "mapping_min_closures": 1,
    "mapping_max_ate": 0.07,
    "mapping_max_reproj": 4e-3,
}

# images probed with synthetic warps (rotation/scale/perspective)
WARP_IMAGES = ["book.jpg", "bike.png", "airplane.jpg", "cat2.jpg"]


def _load_gray(path: str, max_side: int) -> np.ndarray:
    g = sio.read_image(path, resized=False)
    h, w = g.shape
    s = max(h, w) / max_side
    if s > 1.0:
        import cv2
        g = cv2.resize(g, (int(round(w / s)), int(round(h / s)))
                       ).astype(np.float32)
    return g


def _warp(gray: np.ndarray, angle_deg: float, scale: float,
          persp: float, rng) -> tuple:
    """Warp with a known homography; returns (warped, H_0to1)."""
    import cv2
    h, w = gray.shape
    c = (w / 2.0, h / 2.0)
    m = cv2.getRotationMatrix2D(c, angle_deg, scale)
    hm = np.eye(3)
    hm[:2] = m
    hm[2, 0] = persp * rng.uniform(-1, 1) / w
    hm[2, 1] = persp * rng.uniform(-1, 1) / h
    warped = cv2.warpPerspective(gray, hm.astype(np.float64), (w, h))
    return warped.astype(np.float32), hm


def _extract(gray: np.ndarray):
    kp, desc = sift.detect_and_compute(np.asarray(gray, np.float32))
    valid = np.asarray(kp.valid)
    xy = np.stack([np.asarray(kp.x), np.asarray(kp.y)], 1)
    return kp, desc, xy[valid], valid


def eval_repeatability(data_dir: str, max_side: int, rng) -> List[Dict]:
    out = []
    for name in WARP_IMAGES:
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            continue
        gray = _load_gray(path, max_side)
        kp0, d0, xy0, v0 = _extract(gray)
        for (ang, sc, pp) in [(15, 1.0, 0.0), (45, 0.9, 0.0),
                              (0, 0.7, 0.0), (10, 1.0, 0.15)]:
            warped, hm = _warp(gray, ang, sc, pp, rng)
            kp1, d1, xy1, v1 = _extract(warped)
            rep = keypoint_repeatability(xy0, xy1, hm, tol=3.0)
            # matching precision under ground-truth homography
            m = match_ratio(d1, d0, q_valid=kp1.valid, t_valid=kp0.valid)
            good = np.asarray(m.good)
            ti = np.asarray(m.train_idx)
            q_xy = np.stack([np.asarray(kp1.x), np.asarray(kp1.y)], 1)
            t_xy = np.stack([np.asarray(kp0.x), np.asarray(kp0.y)], 1)
            gi = np.where(good)[0]
            correct = 0
            if len(gi):
                src = t_xy[ti[gi]]
                ones = np.ones((len(src), 1))
                proj = np.concatenate([src, ones], 1) @ hm.T
                proj = proj[:, :2] / proj[:, 2:3]
                correct = int((np.linalg.norm(proj - q_xy[gi], axis=1)
                               < 3.0).sum())
            out.append({
                "image": name, "angle": ang, "scale": sc, "persp": pp,
                "kpts": int(v0.sum()), "kpts_warped": int(v1.sum()),
                "repeatability": round(rep, 4),
                "matches": int(len(gi)),
                "match_precision": round(correct / max(len(gi), 1), 4),
            })
    return out


def eval_pairs(data_dir: str, max_side: int) -> List[Dict]:
    out = []
    for scene_name, obj_name in PAIRS:
        sp = os.path.join(data_dir, scene_name)
        op = os.path.join(data_dir, obj_name)
        if not (os.path.exists(sp) and os.path.exists(op)):
            continue
        scene = _load_gray(sp, max_side)
        obj = _load_gray(op, max_side)
        t0 = time.perf_counter()
        kps, ds, _, _ = _extract(scene)
        kpo, do, _, _ = _extract(obj)
        m = match_ratio(do, ds, q_valid=kpo.valid, t_valid=kps.valid)
        src = np.stack([np.asarray(kpo.x), np.asarray(kpo.y)], 1)
        ti = np.asarray(m.train_idx)
        dst = np.stack([np.asarray(kps.x)[ti], np.asarray(kps.y)[ti]], 1)
        hres = find_homography_ransac(src, dst,
                                      valid=np.asarray(m.good))
        dt = time.perf_counter() - t0
        out.append({
            "scene": scene_name, "object": obj_name,
            "scene_kpts": int(np.asarray(kps.count())),
            "object_kpts": int(np.asarray(kpo.count())),
            "good_matches": int(np.asarray(m.good).sum()),
            "inliers": int(np.asarray(hres.n_inliers)),
            "found": bool(np.asarray(hres.ok)),
            "wall_s": round(dt, 3),
        })
    return out


def _golden_gray(data_dir: str, source: str, resized: bool
                 ) -> np.ndarray:
    """Reproduce the exact gray input the reference dump consumed.

    `name_960` sources are the invariance probes pre-resized to
    960x960 on the COLOR image (exactly as tools/ref_dump did) before
    the swapped-gray conversion (src/main.cpp:84 semantics).
    """
    import re
    m = re.fullmatch(r"(.+)_(\d+)(?:x(\d+))?", source)
    if m and not os.path.exists(os.path.join(data_dir, source)):
        import cv2
        stem, a, b = m.group(1), int(m.group(2)), m.group(3)
        size = (a, int(b)) if b else (a, a)       # (W, H)
        bgr = cv2.imread(os.path.join(data_dir, stem + ".jpg"))
        bgr = cv2.resize(bgr, size)
        return sio._gray_swapped_np(bgr)
    return sio.read_image(os.path.join(data_dir, source),
                          resized=resized)


def eval_reference_recall(data_dir: str, golden_path: str = GOLDEN,
                          pairs=None, tol: float = 2.0) -> List[Dict]:
    """Keypoint + match recall vs the compiled reference's own output.

    The golden npz (tools/ref_dump) holds the reference binary's
    keypoints and ratio-tested good matches per demo pair; recall is
    position-based (indices don't transfer between implementations).
    This measures the BASELINE.json >=0.95 gate on its own terms.
    """
    import json as _json
    z = np.load(golden_path)
    meta = _json.loads(bytes(z["meta"]).decode())
    out = []
    for tag, m in meta.items():
        if pairs is not None and tag not in pairs:
            continue
        scene = _golden_gray(data_dir, m["scene"], m["scene_resized"])
        obj = _golden_gray(data_dir, m["object"], False)
        kp_s, d_s, xy_s, _ = _extract(scene)
        kp_o, d_o, xy_o, _ = _extract(obj)
        ref_s = z[f"{tag}_kp_scene"]
        ref_o = z[f"{tag}_kp_object"]
        kr_s = keypoint_recall(ref_s[:, :2], xy_s, tol=tol)
        kr_o = keypoint_recall(ref_o[:, :2], xy_o, tol=tol)
        # our demo-semantics matches: query=object, train=scene
        mm = match_ratio(d_o, d_s, q_valid=kp_o.valid,
                         t_valid=kp_s.valid)
        good = np.asarray(mm.good)
        ti = np.asarray(mm.train_idx)
        q_xy = np.stack([np.asarray(kp_o.x), np.asarray(kp_o.y)], 1)
        t_xy = np.stack([np.asarray(kp_s.x), np.asarray(kp_s.y)], 1)
        gi = np.where(good)[0]
        refm = z[f"{tag}_matches"]
        refm = refm[refm[:, 4] > 0]
        mr = correspondence_recall(
            ref_o[refm[:, 0].astype(int), :2],
            ref_s[refm[:, 1].astype(int), :2],
            q_xy[gi], t_xy[ti[gi]], tol=tol)
        out.append({
            "pair": tag,
            "ref_scene_kpts": int(m["n_scene"]),
            "ref_object_kpts": int(m["n_object"]),
            "scene_kpts": len(xy_s), "object_kpts": len(xy_o),
            "keypoint_recall_scene": round(kr_s, 4),
            "keypoint_recall_object": round(kr_o, 4),
            "ref_good_matches": int(m["n_good"]),
            "good_matches": int(len(gi)),
            "match_recall": round(mr, 4),
        })
    return out


def eval_mapping(n_frames: int = 16, size=(240, 320)) -> Dict:
    """Config-5 end-to-end: rendered procedural-texture loop sequence ->
    full pipeline (sequential SfM, loop closures, pose graph,
    closure-aware global BA, export) -> ATE vs the renderer's exact
    ground-truth poses. See sfm/mapping.py."""
    import tempfile
    from sift_tpu.sfm.mapping import (mapping_ate,
                                      render_corner_sequence,
                                      run_mapping)
    frames, k, gt = render_corner_sequence(n_frames=n_frames, size=size)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        res = run_mapping(frames, k,
                          export_prefix=os.path.join(td, "map"))
        exported = all(os.path.exists(p)
                       for p in res.stats.get("export", {}).values())
    dt = time.perf_counter() - t0
    out = dict(res.stats)
    out.pop("export", None)
    out.update({kk: round(v, 5) for kk, v in
                mapping_ate(res, gt).items()})
    out["reproj_rmse"] = round(out["reproj_rmse"], 6)
    out["exported"] = exported
    out["wall_s"] = round(dt, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sift_tpu.eval")
    ap.add_argument("--data", default="/root/reference/data")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-side", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero if any GATES threshold fails")
    ap.add_argument("--skip-recall", action="store_true")
    ap.add_argument("--skip-mapping", action="store_true",
                    help="skip the config-5 end-to-end mapping eval")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu (default) fails without a GPU; cpu pins "
                         "JAX to the CPU (the quality gates are "
                         "platform-independent)")
    args = ap.parse_args(argv)
    from sift_tpu.utils.device import select_platform
    select_platform(args.platform)

    rng = np.random.default_rng(args.seed)
    report = {
        "repeatability": eval_repeatability(args.data, args.max_side, rng),
        "pairs": eval_pairs(args.data, args.max_side),
    }
    if not args.skip_recall and os.path.exists(GOLDEN):
        report["reference_recall"] = eval_reference_recall(args.data)
    if not args.skip_mapping:
        report["mapping"] = eval_mapping()
    # Per-row justification for low-repeatability warps: the committed
    # oracle comparison (tools/oracle_repeatability.py ->
    # ORACLE_REPEAT.json) shows the quirk-exact NumPy twin of the
    # reference produces the SAME repeatability row by row (scale-0.7
    # weakness included — nOctaveLayers=2 + no initial 2x upsample is
    # the reference algorithm's own scale response, not a pipeline
    # regression). Attach it so the mean-level gate is justified
    # per-row in the artifact itself.
    _orep = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ORACLE_REPEAT.json")
    if os.path.exists(_orep):
        with open(_orep) as _f:
            _od = json.load(_f)
        report["oracle_repeatability_comparison"] = {
            "summary": _od.get("summary"),
            "note": _od.get("note"),
            "rows": _od.get("rows"),
        }
        for row in report["repeatability"]:
            for orow in _od.get("rows", []):
                if (orow["image"] == row["image"]
                        and orow["angle"] == row["angle"]
                        and orow["scale"] == row["scale"]):
                    row["oracle_repeatability_reduced_res"] = \
                        orow["oracle_repeatability"]
                    row["pipeline_repeatability_reduced_res"] = \
                        orow["pipeline_repeatability"]
    reps = [r["repeatability"] for r in report["repeatability"]]
    precs = [r["match_precision"] for r in report["repeatability"]]
    report["summary"] = {
        "mean_repeatability": round(float(np.mean(reps)), 4) if reps else None,
        "mean_match_precision": round(float(np.mean(precs)), 4) if precs else None,
        "pairs_found": sum(p["found"] for p in report["pairs"]),
        "pairs_total": len(report["pairs"]),
    }
    if "reference_recall" in report:
        rr = report["reference_recall"]
        krs = ([r["keypoint_recall_scene"] for r in rr]
               + [r["keypoint_recall_object"] for r in rr])
        # weighted mean for reporting; the GATE below is per-pair so a
        # single-config collapse can't hide in an average. Per pair:
        # absolute misses <= 1 always passes (one borderline match is
        # noise at any size), otherwise raw recall must clear the
        # threshold AND the pair must have >= 10 reference matches for
        # the ratio to mean anything. A small pair (< 10 matches) with
        # >= 2 misses fails outright — the round-2 floor that forgave
        # one miss regardless of pair size let a 2-match pair pass at
        # 50% recall; misses are bounded now, not erased.
        w = np.array([r["ref_good_matches"] for r in rr], float)
        mrs = np.array([r["match_recall"] for r in rr])

        def _pair_gate_ok(r):
            n_ref = max(r["ref_good_matches"], 1)
            misses = round((1.0 - r["match_recall"]) * n_ref)
            if misses <= 1:
                return True
            return (n_ref >= 10
                    and r["match_recall"] >= GATES["min_match_recall"])

        match_pairs_failed = [r["pair"] for r in rr
                              if not _pair_gate_ok(r)]
        report["summary"]["min_keypoint_recall"] = round(min(krs), 4)
        report["summary"]["mean_keypoint_recall"] = round(
            float(np.mean(krs)), 4)
        report["summary"]["match_recall"] = round(
            float((w * mrs).sum() / w.sum()), 4)
        report["summary"]["min_match_recall"] = round(float(mrs.min()), 4)
        report["summary"]["match_pairs_failed"] = match_pairs_failed

    s = report["summary"]
    failures = []
    if "reference_recall" in report:
        if s["min_keypoint_recall"] < GATES["min_keypoint_recall"]:
            failures.append("keypoint_recall")
        if (s["match_recall"] < GATES["min_match_recall"]
                or s["match_pairs_failed"]):
            failures.append("match_recall")
    if s["mean_repeatability"] is not None:
        if s["mean_repeatability"] < GATES["min_mean_repeatability"]:
            failures.append("repeatability")
        if s["mean_match_precision"] < GATES["min_mean_match_precision"]:
            failures.append("match_precision")
    if s["pairs_found"] < min(GATES["min_pairs_found"], s["pairs_total"]):
        failures.append("pairs_found")
    if "mapping" in report:
        mp = report["mapping"]
        if (mp["n_registered"] < GATES["mapping_min_registered_frac"]
                * mp["n_frames"]
                or mp["n_closures"] < GATES["mapping_min_closures"]
                or mp["ate_final"] > GATES["mapping_max_ate"]
                or mp["reproj_rmse"] > GATES["mapping_max_reproj"]
                or not mp["exported"]):
            failures.append("mapping")
    report["summary"]["gates_failed"] = failures

    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    if args.gate and failures:
        print(f"EVAL GATES FAILED: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
