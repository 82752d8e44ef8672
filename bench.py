"""Benchmark: detect+describe+match at 1080p on one GPU.

    python bench.py                 # headline: frames/s over frame pairs
    python bench.py --stages        # per-stage prefix timings at 1080p
    python bench.py --batch B       # B frames per program (throughput)
    python bench.py --batch-sweep   # B x resolution matrix (ignores --hw)
    python bench.py --ori-ab        # ori_hist_impl A/B (detect)
    python bench.py --descr-ab      # descr_layout A/B (detect+describe)
    python bench.py --band          # blur on spatial-tiling band shapes

Every mode needs a GPU and exits non-zero without one. Inputs are
seeded textured frames (sift_tpu.synth). Times are host-clock wall
time around calls ended by `jax.block_until_ready`, after a warm-up
call that compiles;
each result is one JSON line stamped with the device (platform,
device_kind, count) and the card's nvidia-smi name and power limit.

Baseline denominator: the reference C++ pipeline measured on a 16-thread
CPU host at 1920x1080 — 10.28 s per frame for SIFT_NCL (BASELINE.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

REF_SECONDS_PER_FRAME_1080P = 10.28  # BASELINE.md, reference on CPU
HD = (1080, 1920)


def _time_ms(fn, reps: int = 20) -> dict:
    """Median / p90 ms of fn() over reps calls after one warm-up call,
    each call ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ts)),
            "p90_ms": float(np.percentile(ts, 90)), "reps": reps}


def _emit(result: dict) -> None:
    from sift_tpu.utils.device import device_stamp
    print(json.dumps({**result, "device": device_stamp()}), flush=True)


def bench_headline(hw, reps: int) -> None:
    """One pipeline step = extract two 1080p frames + match them."""
    import jax.numpy as jnp
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops import match as match_mod

    f0, f1 = (jnp.asarray(f) for f in synth.frame_pair(hw, seed=0))

    def step():
        kp0, d0 = sift.detect_and_compute(f0, CFG)
        kp1, d1 = sift.detect_and_compute(f1, CFG)
        return match_mod.match_ratio(d1, d0, q_valid=kp1.valid,
                                     t_valid=kp0.valid,
                                     ratio=CFG.match_ratio)

    t = _time_ms(step, reps)
    fps = 2.0 / (t["median_ms"] / 1e3)
    _emit({"metric": "detect_describe_match", "hw": list(hw),
           "value": fps, "unit": "frames/s", "step_ms": t,
           "vs_baseline": fps * REF_SECONDS_PER_FRAME_1080P})


def bench_stages(hw, reps: int) -> None:
    """Prefix programs at 1080p, each one jit: pyramid+DoG; + extrema
    NMS and top-k; + refinement; + orientation (= detect); + descriptor
    (= detect_and_compute); the matcher alone; the whole demo
    (pipeline.detect_object). A stage's cost is the difference of two
    prefixes."""
    import jax
    import jax.numpy as jnp
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops import extrema as ext
    from sift_tpu.ops import match as match_mod
    from sift_tpu.ops import pyramid as pyr
    from sift_tpu.ops import refine as ref
    from sift_tpu.pipeline import detect_object

    ps = synth.planar_scene(hw, seed=0)
    f0 = jnp.asarray(ps.scene)
    obj = jnp.asarray(ps.object)

    def upto(stage):
        @jax.jit
        def fn(img):
            octs = pyr.build_gaussian_pyramid(img, CFG)
            dogs = pyr.build_dog_pyramid(octs)
            if stage == "pyramid":
                return dogs
            outs = []
            for o in range(CFG.n_octaves):
                cands = ext.top_candidates(dogs[o], CFG.detect_caps[o], CFG)
                if stage == "extrema":
                    outs.append(cands)
                    continue
                outs.append(ref.refine_candidates(dogs[o], *cands, CFG))
            return outs
        return fn

    fns = {"pyramid_dog": upto("pyramid"), "extrema_topk": upto("extrema"),
           "refine": upto("refine")}
    t = {k: _time_ms(lambda f=f: f(f0), reps) for k, f in fns.items()}
    t["detect"] = _time_ms(lambda: sift.detect(f0, CFG), reps)
    t["detect_describe"] = _time_ms(
        lambda: sift.detect_and_compute(f0, CFG), reps)
    kp, d = sift.detect_and_compute(f0, CFG)
    t["match_1536x1536"] = _time_ms(lambda: match_mod.match_ratio(
        d, d, q_valid=kp.valid, t_valid=kp.valid), reps)
    t["detect_object"] = _time_ms(lambda: detect_object(f0, obj, CFG), reps)
    med = {k: v["median_ms"] for k, v in t.items()}
    _emit({"mode": "stages", "image": f"synth.planar_scene {hw}",
           "prefix_ms": t,
           "stage_ms": {
               "pyramid_dog": med["pyramid_dog"],
               "extrema_topk": med["extrema_topk"] - med["pyramid_dog"],
               "refine": med["refine"] - med["extrema_topk"],
               "orientation": med["detect"] - med["refine"],
               "descriptor": med["detect_describe"] - med["detect"],
               "match": med["match_1536x1536"]}})


def _frames_per_s(batch: int, hw, reps: int) -> float:
    """frames/s at one (B, resolution) point. B == 1 runs the latency
    path (detect_and_compute per frame, one match per pair); B > 1 the
    throughput path (detect_and_compute_batch + vmapped
    consecutive-frame matching)."""
    import jax
    import jax.numpy as jnp
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops import match as match_mod

    frames = [synth.textured_image(*hw, seed=i) for i in range(max(batch, 2))]
    if batch == 1:
        f0, f1 = jnp.asarray(frames[0]), jnp.asarray(frames[1])

        def step():
            kp0, d0 = sift.detect_and_compute(f0, CFG)
            kp1, d1 = sift.detect_and_compute(f1, CFG)
            return match_mod.match_ratio(d1, d0, q_valid=kp1.valid,
                                         t_valid=kp0.valid)
        per_step = 2.0
    else:
        fb = jnp.asarray(np.stack(frames))

        def step():
            kp, d = sift.detect_and_compute_batch(fb, CFG)
            return jax.vmap(lambda di, vi, dj, vj: match_mod.match_ratio(
                di, dj, q_valid=vi, t_valid=vj))(
                    d[1:], kp.valid[1:], d[:-1], kp.valid[:-1])
        per_step = float(batch)
    return per_step / (_time_ms(step, reps)["median_ms"] / 1e3)


def bench_batch(batch: int, hw, reps: int) -> None:
    _emit({"metric": f"detect_describe_match_batch{batch}", "hw": list(hw),
           "value": _frames_per_s(batch, hw, reps), "unit": "frames/s"})


def bench_batch_sweep(reps: int) -> None:
    """B in {1, 4, 8} x {480p, 720p, 1080p}: does the batched path beat
    per-frame latency dispatch on one device?"""
    sizes = {"480p": (480, 854), "720p": (720, 1280), "1080p": HD}
    matrix = {name: {f"B{b}": _frames_per_s(b, hw, reps)
                     for b in (1, 4, 8)} for name, hw in sizes.items()}
    _emit({"mode": "batch_sweep", "unit": "frames/s", "matrix": matrix})


def _config_ab(field: str, values, stage: str, hw, reps: int) -> None:
    """Time one stage under each value of one SIFTConfig field."""
    import jax.numpy as jnp
    from sift_tpu import sift, synth
    from sift_tpu.config import DEFAULT_CONFIG

    f0 = jnp.asarray(synth.textured_image(*hw, seed=0))
    out = {}
    for v in values:
        cfg = dataclasses.replace(DEFAULT_CONFIG, **{field: v})
        fn = sift.detect if stage == "detect" else sift.detect_and_compute
        out[str(v)] = _time_ms(lambda: fn(f0, cfg), reps)
    _emit({"mode": f"{field}_ab", "stage": stage, "hw": list(hw),
           "ms": out})


def bench_band(reps: int) -> None:
    """Blur on the per-device band shapes of the spatially tiled path
    (a 2160x3840 frame over 4 and 8 devices, halo 64)."""
    import jax
    import jax.numpy as jnp
    from sift_tpu.config import DEFAULT_CONFIG as CFG
    from sift_tpu.ops.conv import gaussian_blur_multi

    sig = CFG.scale_sigmas()[1:]
    blur = jax.jit(lambda x: gaussian_blur_multi(x, sig))
    rng = np.random.default_rng(0)
    out = {}
    for n_dev in (4, 8):
        hb = -(-2160 // n_dev) + 2 * 64
        x = jnp.asarray(rng.random((hb, 3840), np.float32) * 255)
        out[f"{n_dev}dev_{hb}x3840"] = _time_ms(lambda: blur(x), reps)
    _emit({"mode": "band", "ms": out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stages", action="store_true")
    mode.add_argument("--batch", type=int, default=0)
    mode.add_argument("--batch-sweep", action="store_true")
    mode.add_argument("--ori-ab", action="store_true")
    mode.add_argument("--descr-ab", action="store_true")
    mode.add_argument("--band", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--hw", type=int, nargs=2, default=HD,
                    metavar=("H", "W"), help="frame size (default 1080p)")
    args = ap.parse_args(argv)

    from sift_tpu.utils.device import require_gpu
    from sift_tpu.utils.compile_cache import enable_compile_cache
    require_gpu()
    enable_compile_cache()

    hw = tuple(args.hw)
    if args.stages:
        bench_stages(hw, args.reps)
    elif args.batch:
        bench_batch(args.batch, hw, args.reps)
    elif args.batch_sweep:
        bench_batch_sweep(args.reps)
    elif args.ori_ab:
        _config_ab("ori_hist_impl", ("onehot", "onehot_t", "factored"),
                   "detect", hw, args.reps)
    elif args.descr_ab:
        _config_ab("descr_layout", ("pk", "kp"), "detect_describe", hw,
                   args.reps)
    elif args.band:
        bench_band(args.reps)
    else:
        bench_headline(hw, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
