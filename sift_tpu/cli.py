"""Command-line driver (replaces reference C1, src/main.cpp:10-76).

Usage mirrors the reference (`./sift <scene> <object>`):

    python -m sift_tpu.cli <scene> <object> [--out matches.png]
                           [--ratio 0.86] [--no-resize] [--timing]

Instead of imshow/waitKey (src/main.cpp:69-70) the visualization is
written to a file with --out. Prints match/homography stats and, with
--timing, the per-stage device timings the reference printf'd.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from sift_tpu.utils.compile_cache import enable_compile_cache

# persist XLA compilations across processes: later CLI runs on the
# same shapes hit the cache
enable_compile_cache()

from sift_tpu import io as sio  # noqa: E402
from sift_tpu.config import DEFAULT_CONFIG  # noqa: E402
from sift_tpu.pipeline import detect_object  # noqa: E402
from sift_tpu.utils.profiling import StageTimer  # noqa: E402


def _draw(scene_path: str, obj_path: str, det, out_path: str) -> None:
    """drawMatches + green box twin (src/main.cpp:42,65-68)."""
    import cv2
    scene = cv2.resize(cv2.imread(scene_path), (960, 960))
    obj = cv2.imread(obj_path)
    good = np.asarray(det.matches.good)
    tidx = np.asarray(det.matches.train_idx)
    ox, oy = np.asarray(det.object_kp.x), np.asarray(det.object_kp.y)
    sx, sy = np.asarray(det.scene_kp.x), np.asarray(det.scene_kp.y)
    h_o, w_o = obj.shape[:2]
    canvas = np.zeros((max(960, h_o), 960 + w_o, 3), np.uint8)
    canvas[:h_o, :w_o] = obj
    canvas[:960, w_o:] = scene
    for q in np.where(good)[0]:
        p0 = (int(ox[q]), int(oy[q]))
        p1 = (int(sx[tidx[q]]) + w_o, int(sy[tidx[q]]))
        cv2.line(canvas, p0, p1, (0, 0, 255), 1)
    if bool(np.asarray(det.found)):
        c = np.asarray(det.corners).astype(int)
        for i in range(4):
            p0 = (c[i][0] + w_o, c[i][1])
            p1 = (c[(i + 1) % 4][0] + w_o, c[(i + 1) % 4][1])
            cv2.line(canvas, p0, p1, (0, 255, 0), 4)
    cv2.imwrite(out_path, canvas)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sift_tpu", description="SIFT object detection in JAX")
    ap.add_argument("scene")
    ap.add_argument("object")
    ap.add_argument("--out", default=None,
                    help="write match visualization to this file")
    ap.add_argument("--ratio", type=float, default=DEFAULT_CONFIG.match_ratio)
    ap.add_argument("--no-resize", action="store_true",
                    help="skip the 960x960 scene resize (src/main.cpp:83)")
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--diagnose-caps", action="store_true",
                    help="also count dense NMS survivors against "
                         "detect_caps (rebuilds the pyramid once per "
                         "image — diagnostic, not free)")
    args = ap.parse_args(argv)

    timer = StageTimer(enabled=True)
    with timer.stage("ingest"):
        scene = sio.read_image(args.scene, resized=not args.no_resize)
        obj = sio.read_image(args.object, resized=False)
        timer.sink(None)

    import dataclasses
    cfg = dataclasses.replace(DEFAULT_CONFIG, match_ratio=args.ratio)

    with timer.stage("pipeline(compile+run)"):
        det = detect_object(scene, obj, cfg=cfg)
        timer.sink(det.corners)
    with timer.stage("pipeline(steady)"):
        det = detect_object(scene, obj, cfg=cfg)
        timer.sink(det.corners)

    # cap-saturation counters: a full octave batch means out_caps may
    # have truncated (reference emits unboundedly, src/sift.cpp:538)
    from sift_tpu import sift as _sift
    from sift_tpu.utils.logger import COUNTERS, get_logger
    from sift_tpu.ops import pyramid as _pyr
    for name, kp, img in (("scene", det.scene_kp, scene),
                          ("object", det.object_kp, obj)):
        sat = np.asarray(_sift.octave_saturation(kp, cfg))
        for o in np.where(sat)[0]:
            COUNTERS.inc(f"out_cap_saturated/{name}/octave{o}")
            get_logger("cli").warning(
                "octave %d of %s hit out_caps[%d]=%d: weakest keypoints "
                "may be truncated; raise SIFTConfig.out_caps",
                o, name, o, cfg.out_caps[o])
        # candidate-level truncation happens before refinement and is
        # invisible in the output batch (the rotate1080 lesson) —
        # count the dense NMS mask directly. Opt-in: this rebuilds the
        # pyramid (the pipeline's dominant cost) once per image
        if not args.diagnose_caps:
            continue
        csat = np.asarray(_sift.candidate_saturation(
            _pyr.build_gaussian_pyramid(img, cfg), cfg))
        for o in np.where(csat)[0]:
            COUNTERS.inc(f"detect_cap_saturated/{name}/octave{o}")
            get_logger("cli").warning(
                "octave %d of %s exceeded detect_caps[%d]=%d NMS "
                "survivors: weakest candidates dropped pre-refinement; "
                "raise SIFTConfig.detect_caps",
                o, name, o, cfg.detect_caps[o])

    n_scene = int(np.asarray(det.scene_kp.count()))
    n_obj = int(np.asarray(det.object_kp.count()))
    n_good = int(np.asarray(det.matches.good).sum())
    n_inl = int(np.asarray(det.n_inliers))
    found = bool(np.asarray(det.found))
    print(f"scene keypoints:  {n_scene}")
    print(f"object keypoints: {n_obj}")
    print(f"good matches:     {n_good}")
    print(f"RANSAC inliers:   {n_inl}")
    print(f"object found:     {found}")
    if found:
        c = np.asarray(det.corners)
        print("corners in scene: "
              + ", ".join(f"({x:.1f},{y:.1f})" for x, y in c))
    if args.timing:
        print(timer.report())
    if args.out:
        _draw(args.scene, args.object, det, args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
