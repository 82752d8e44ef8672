"""Cascade-matcher validation at map scale.

Builds a train set from real SIFT descriptors of ten seeded textured
images (sift_tpu.synth) plus jittered copies, up to 128k rows,
measures ratio-test DECISION agreement between the cascade matcher
and the exact matcher, sweeping the candidate count C against the
train size M, and times both paths (wall time including compilation).
Prints one JSON line per point; --out also writes them to a file.

Runs on the GPU and fails without one; --platform cpu rehearses the
agreement numbers on the CPU (its wall times are CPU times).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _image_descriptors(n_images: int = 10, hw=(480, 640)):
    """Valid descriptors of n seeded textured images (the object
    texture: dense enough for hundreds of keypoints each)."""
    import jax.numpy as jnp
    from sift_tpu import sift, synth
    out = []
    for i in range(n_images):
        g = synth.object_image(*hw, seed=1000 + i)
        kp, d = sift.detect_and_compute(jnp.asarray(g))
        out.append(np.asarray(d)[np.asarray(kp.valid)])
    return out


def _grow(base: np.ndarray, m: int, rng) -> np.ndarray:
    """Image descriptors + sqrt-domain jittered copies up to m rows
    (keeps the sqrt-L1 distance structure of real descriptors, unlike
    uniform noise)."""
    rows = [base]
    total = len(base)
    i = 0
    while total < m:
        jit = np.sqrt(np.maximum(
            base ** 2 + rng.normal(0, 2e-4 * (1 + i), base.shape), 0.0)
        ).astype(np.float32)
        rows.append(jit)
        total += len(jit)
        i += 1
    return np.concatenate(rows)[:m]


def main() -> int:
    ap = argparse.ArgumentParser(prog="bench_cascade")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--n-query", type=int, default=2048)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from sift_tpu.utils.compile_cache import enable_compile_cache
    from sift_tpu.utils.device import select_platform
    select_platform(args.platform)
    enable_compile_cache()
    import jax.numpy as jnp
    from sift_tpu.ops.match import match_ratio
    from sift_tpu.ops.match_cascade import match_ratio_cascade

    rng = np.random.default_rng(0)
    per_img = _image_descriptors()
    query = per_img[0][:args.n_query]
    base = np.concatenate(per_img[1:])
    print(f"# query {len(query)} image-distractors {len(base)}",
          file=sys.stderr)

    records = []
    for m in (8192, 32768, 131072):
        # the map-retrieval setting: the train set holds the queries'
        # true re-observations (jittered twins, prepended) among a
        # sea of distractors from the other images — exact_good is then
        # substantial, so agreement measures BOTH missed matches and
        # candidate-truncation hallucinations (a shrunken candidate
        # set can shrink d2 and pass the ratio test spuriously)
        twins = np.sqrt(np.maximum(
            query ** 2 + rng.normal(0, 3e-4, query.shape), 0.0)
        ).astype(np.float32)
        train = np.concatenate(
            [twins, _grow(base, m - len(twins), rng)])
        q = jnp.asarray(query)
        t = jnp.asarray(train)
        t0 = time.perf_counter()
        exact = match_ratio(q, t)
        ge = np.asarray(exact.good)
        te = np.asarray(exact.train_idx)
        t_exact = time.perf_counter() - t0
        # the adversarial complement: a query set with NO true match
        # in train (second image's descriptors, absent from it) — here
        # the cascade's only failure mode is HALLUCINATING a good
        # match (truncated candidates shrink d2, passing the ratio)
        q_nm = jnp.asarray(per_img[1][:args.n_query])
        t_nm = jnp.asarray(np.concatenate(
            [twins, _grow(np.concatenate(per_img[2:]),
                          m - len(twins), rng)]))
        ge_nm = np.asarray(match_ratio(q_nm, t_nm).good)
        for c in (32, 64, 128, 256):
            t0 = time.perf_counter()
            casc = match_ratio_cascade(q, t, n_candidates=c)
            gc = np.asarray(casc.good)
            tc = np.asarray(casc.train_idx)
            t_casc = time.perf_counter() - t0
            agree = float(((ge == gc) & (~ge | (te == tc))).mean())
            recall = float(((gc & (te == tc))[ge]).mean()) if ge.any() \
                else None
            false_good = int((gc & ~ge).sum())
            casc_nm = match_ratio_cascade(q_nm, t_nm, n_candidates=c)
            halluc = int((np.asarray(casc_nm.good) & ~ge_nm).sum())
            rec = {"m": m, "c": c,
                   "hallucinated_nomatch": halluc,
                   "n_query_nomatch": int(q_nm.shape[0]),
                   "agreement": round(agree, 5),
                   "exact_good": int(ge.sum()),
                   "cascade_good": int(gc.sum()),
                   "good_recall": round(recall, 5)
                   if recall is not None else None,
                   "false_good": false_good,
                   "wall_exact_s": round(t_exact, 3),
                   "wall_cascade_s": round(t_casc, 3),
                   "platform": args.platform}
            records.append(rec)
            print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"n_query": len(query), "records": records}, f,
                      indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
