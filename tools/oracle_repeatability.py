"""Pin the scale-0.7 repeatability question.

The eval harness's warp battery (sift_tpu.eval) showed repeatability ~0.41 at scale 0.7 on
book.jpg (the 0.60 gate passes only on the mean). Two hypotheses:
  (a) inherited from the reference algorithm itself — nOctaveLayers=2
      and no initial 2x upsampling (createInitialImage ignores its
      doubleSize arg, /root/reference/src/sift.cpp:219-227) give weak
      scale invariance by construction;
  (b) a real scale-robustness regression in our pipeline (candidate-cap
      or border effects under warp).

This script answers it by running the SAME warp battery through the
quirk-exact NumPy oracle (sift_tpu/oracle/cpu_sift.py — per-function
src/sift.cpp citations) AND through the live pipeline, pinned to CPU,
at reduced resolution (the oracle is per-pixel Python). If the oracle's
scale-0.7 repeatability is as low as the pipeline's, (a) holds and the
per-row gate level is justified by the reference's own algorithm.

Writes ORACLE_REPEAT.json. Run: python tools/oracle_repeatability.py
"""

from __future__ import annotations

import json
import os
import sys
import time

# pin to CPU BEFORE importing jax (as tests/conftest.py does): the
# oracle comparison is a CPU accuracy study
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sift_tpu import sift  # noqa: E402
from sift_tpu.eval import WARP_IMAGES, _load_gray, _warp  # noqa: E402
from sift_tpu.oracle import cpu_sift as oracle  # noqa: E402
from sift_tpu.utils.metrics import keypoint_repeatability  # noqa: E402

# the same warp battery as eval_repeatability (sift_tpu/eval.py)
WARPS = [(15, 1.0, 0.0), (45, 0.9, 0.0), (0, 0.7, 0.0), (10, 1.0, 0.15)]


def _oracle_xy(gray: np.ndarray) -> np.ndarray:
    gpyr = oracle.build_gaussian_pyramid(gray)
    dog = oracle.build_dog_pyramid(gpyr)
    kpts = oracle.find_scale_space_extrema(gpyr, dog)
    if not kpts:
        return np.zeros((0, 2), np.float32)
    return np.array([[k["x"], k["y"]] for k in kpts], np.float32)


def _pipeline_xy(gray: np.ndarray) -> np.ndarray:
    kp, _ = sift.detect_and_compute(np.asarray(gray, np.float32))
    valid = np.asarray(kp.valid)
    xy = np.stack([np.asarray(kp.x), np.asarray(kp.y)], 1)
    return xy[valid]


def main() -> int:
    max_side = int(os.environ.get("ORACLE_REPEAT_MAX_SIDE", "220"))
    rng = np.random.default_rng(7)
    rows = []
    for name in WARP_IMAGES:
        path = os.path.join("/root/reference/data", name)
        if not os.path.exists(path):
            continue
        gray = _load_gray(path, max_side)
        t0 = time.time()
        xy0_o = _oracle_xy(gray)
        xy0_p = _pipeline_xy(gray)
        for (ang, sc, pp) in WARPS:
            warped, hm = _warp(gray, ang, sc, pp, rng)
            rep_o = keypoint_repeatability(
                xy0_o, _oracle_xy(warped), hm, tol=3.0)
            rep_p = keypoint_repeatability(
                xy0_p, _pipeline_xy(warped), hm, tol=3.0)
            rows.append({
                "image": name, "angle": ang, "scale": sc, "persp": pp,
                "oracle_repeatability": round(float(rep_o), 4),
                "pipeline_repeatability": round(float(rep_p), 4),
                "kpts_oracle": int(len(xy0_o)),
                "kpts_pipeline": int(len(xy0_p)),
            })
            print(json.dumps(rows[-1]), flush=True)
        print(f"# {name}: {time.time() - t0:.0f}s", file=sys.stderr)

    s07 = [r for r in rows if r["scale"] == 0.7]
    other = [r for r in rows if r["scale"] != 0.7]

    def _mean(rs, k):
        return round(float(np.mean([r[k] for r in rs])), 4) if rs else None

    out = {
        "max_side": max_side,
        "note": ("same warp battery as eval_repeatability, at reduced "
                 "resolution; oracle = quirk-exact NumPy twin of the "
                 "reference (nOctaveLayers=2, no initial 2x upsample). "
                 "If oracle scale-0.7 repeatability is comparably low, "
                 "the weak scale invariance is the reference "
                 "algorithm's, not a pipeline regression."),
        "rows": rows,
        "summary": {
            "scale07_oracle_mean": _mean(s07, "oracle_repeatability"),
            "scale07_pipeline_mean": _mean(s07, "pipeline_repeatability"),
            "other_oracle_mean": _mean(other, "oracle_repeatability"),
            "other_pipeline_mean": _mean(other, "pipeline_repeatability"),
        },
    }
    gap = (out["summary"]["scale07_oracle_mean"] or 0) \
        - (out["summary"]["scale07_pipeline_mean"] or 0)
    out["summary"]["scale07_pipeline_minus_oracle"] = round(-gap, 4)
    out["summary"]["inherited_from_reference_algorithm"] = bool(
        abs(gap) < 0.10)
    with open(os.path.join(REPO, "ORACLE_REPEAT.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
