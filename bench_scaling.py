"""Falsifiable multi-device scaling check for the distributed BA.

Strong-scaling "efficiency" on a virtual CPU mesh says nothing: 8
virtual devices share one silicon, so efficiency ~1/n is the expected
reading. This harness measures properties that would actually flip on
a collective-graph regression:

1. **Collective census** (the core artifact): lower + compile each
   sharded adjuster at mesh widths 2/4/8 and parse the compiled HLO
   for collective ops (all-reduce / all-gather / reduce-scatter /
   collective-permute / all-to-all), counting instructions and output
   bytes. The design claims under test (sift_tpu/parallel/ba.py
   docstrings):
     - obs-sharded BA: per-iteration wire traffic is the replicated
       block tensors O(C*36 + P*9) — byte volume and op count must be
       INDEPENDENT of mesh width (the observation table never crosses
       the mesh);
     - point-sharded BA: only the camera system crosses the mesh —
       byte volume O(C*36), independent of width AND of point count.
   A regression that e.g. all-gathers the observation table or the
   point blocks blows these up immediately.

2. **Weak scaling**: fixed per-device observation count; wall time on
   a shared-silicon virtual mesh should grow ~linearly with width
   (total work grows with width but runs on the same cores). The
   falsifiable signal is super-linear growth — a collective graph
   whose cost scales with width.

Run: python bench_scaling.py               # the GPUs of this host
     python bench_scaling.py --platform cpu --devices 8   # rehearsal
(the census is platform-independent — the partitioner emits the same
collective graph for CPU virtual devices as for a GPU mesh; scaling
efficiency over NVLink needs the real cards.)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
    "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")

_SHAPE_RE = re.compile(r"\b(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32"
                       r"|u32|s64|u64|c64|c128)\[([0-9,]*)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_census(hlo_text: str) -> dict:
    """Count collective instructions and their output bytes in
    compiled HLO text. Start/done pairs (async collectives) are
    counted once via the -start form."""
    counts: dict[str, int] = {}
    bytes_: dict[str, int] = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        if "=" not in line:
            continue
        _, rhs = line.split("=", 1)
        for op in _COLLECTIVES:
            # match the opcode heading the RHS expression (shape comes
            # first: `%x = f32[64,6,6]{...} all-reduce(...)`), skipping
            # the -done halves of async pairs
            m = re.search(rf"\b{op}(-start)?\(", rhs)
            if m and f"{op}-done" not in rhs:
                shapes = rhs[:m.start()]
                if m.group(1):
                    # async -start results are tuples aliasing the
                    # input buffer; count only the result element so
                    # async-ification doesn't double the byte census
                    last = list(_SHAPE_RE.finditer(shapes))
                    if last:
                        shapes = last[-1].group(0)
                counts[op] = counts.get(op, 0) + 1
                bytes_[op] = bytes_.get(op, 0) + _shape_bytes(shapes)
                break
    return {"counts": counts, "bytes": bytes_,
            "total_ops": sum(counts.values()),
            "total_bytes": sum(bytes_.values())}


def _make_problem(rng, c, p, o):
    import jax.numpy as jnp
    from sift_tpu.sfm.ba import BAProblem
    pts = np.stack([rng.uniform(-3, 3, p), rng.uniform(-3, 3, p),
                    rng.uniform(6, 14, p)], 1).astype(np.float32)
    cams = np.zeros((c, 6), np.float32)
    cams[:, 3] = np.linspace(-1, 1, c)
    cam_idx = rng.integers(0, c, o).astype(np.int32)
    pt_idx = rng.integers(0, p, o).astype(np.int32)
    xc = pts[pt_idx] + cams[cam_idx][:, 3:]
    uv = (xc[:, :2] / xc[:, 2:3]
          + rng.normal(0, 1e-3, (o, 2))).astype(np.float32)
    fixed = np.zeros(c, bool)
    fixed[0] = True
    cams0 = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32) \
        * ~fixed[:, None]
    import jax.numpy as jnp
    return BAProblem(jnp.asarray(cams0), jnp.asarray(pts),
                     jnp.asarray(cam_idx), jnp.asarray(pt_idx),
                     jnp.asarray(uv), jnp.ones(o, bool),
                     jnp.asarray(fixed))


def _parse():
    ap = argparse.ArgumentParser(prog="bench_scaling")
    ap.add_argument("--devices", type=int, default=8,
                    help="device count (>= 2): the GPUs used, or the "
                         "virtual CPU devices with --platform cpu")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu (default): the host's GPUs, failing "
                         "without them; cpu: a virtual CPU mesh, to "
                         "rehearse")
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--pts", type=int, default=4096)
    ap.add_argument("--obs", type=int, default=65536)
    ap.add_argument("--obs-per-device", type=int, default=8192,
                    help="weak-scaling observation shard size")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cg-iters", type=int, default=10)
    ap.add_argument("--json-out", default=None)
    return ap.parse_args()


def main() -> int:
    args = _parse()
    if args.devices < 2:
        print("--devices must be >= 2 (need at least one sharded "
              "mesh width)", file=sys.stderr)
        return 2
    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.devices}").strip()
    import jax
    from sift_tpu.utils.device import select_platform
    select_platform(args.platform)
    if args.platform == "gpu":
        args.devices = min(args.devices, len(jax.devices()))
        if args.devices < 2:
            print("--platform gpu needs at least two GPUs "
                  f"(found {len(jax.devices())})", file=sys.stderr)
            return 2
    import functools
    from jax.sharding import Mesh, PartitionSpec as P
    from sift_tpu.parallel import make_mesh
    from sift_tpu.parallel.ba import (bundle_adjust_sharded,
                                      _point_sharded_device_fn,
                                      point_sharded_inputs)

    rng = np.random.default_rng(0)
    widths = [w for w in (2, 4, 8) if w <= args.devices]
    out = {"config": {"cams": args.cams, "pts": args.pts,
                      "obs": args.obs, "iters": args.iters,
                      "cg_iters": args.cg_iters},
           "census": {}, "weak_scaling": []}

    # ---- 1. collective census at each mesh width --------------------
    prob = _make_problem(rng, args.cams, args.pts, args.obs)

    def lower_obs_sharded(mesh):
        fn = functools.partial(bundle_adjust_sharded, mesh=mesh,
                               iters=args.iters, cg_iters=args.cg_iters)
        return jax.jit(fn).lower(prob).compile().as_text()

    def lower_point_sharded(mesh):
        fn = _point_sharded_device_fn(mesh, args.iters, args.cg_iters,
                                      3e-3, "huber", 1e-3)
        inputs, _ = point_sharded_inputs(prob, mesh)
        return jax.jit(fn).lower(*inputs).compile().as_text()

    for name, lower in (
        ("obs_sharded", lower_obs_sharded),
        ("point_sharded", lower_point_sharded),
    ):
        rows = []
        for w in widths:
            mesh = make_mesh((w,), ("data",))
            c = collective_census(lower(mesh))
            c["devices"] = w
            rows.append(c)
            print(json.dumps({"metric": f"ba_collectives_{name}",
                              **c}))
        out["census"][name] = rows
        # the falsifiable claims, enforced right here:
        ops = [r["total_ops"] for r in rows]
        byt = [r["total_bytes"] for r in rows]
        claim_ops = len(set(ops)) == 1
        # bytes: allow small variance (padding of C/P blocks), not
        # growth proportional to width
        claim_bytes = max(byt) <= 1.25 * min(byt)
        out["census"][name + "_claims"] = {
            "op_count_width_independent": claim_ops,
            "byte_volume_width_independent": claim_bytes,
        }
        if not (claim_ops and claim_bytes):
            print(f"CLAIM VIOLATION for {name}: ops={ops} bytes={byt}",
                  file=sys.stderr)
    # point-sharded must also move strictly less than obs-sharded
    # (camera system only, no point blocks on the wire)
    b_obs = out["census"]["obs_sharded"][0]["total_bytes"]
    b_pt = out["census"]["point_sharded"][0]["total_bytes"]
    out["census"]["point_lt_obs_bytes"] = bool(b_pt < b_obs)

    # ---- 2. weak scaling: fixed observations per device --------------
    # Every row — width 1 included — runs the SAME shard_map program on
    # a w-device mesh (a width-1 row running the unsharded adjuster
    # would measure dispatch overhead, not scaling signal).
    for w in [1] + widths:
        o = args.obs_per_device * w
        p = min(args.pts, o // 4)
        probw = _make_problem(rng, args.cams, p, o)
        mesh = make_mesh((w,), ("data",))
        fn = lambda: bundle_adjust_sharded(
            probw, mesh, iters=args.iters, cg_iters=args.cg_iters)
        np.asarray(fn().cameras)        # compile
        best = min(_timed(fn) for _ in range(3))
        rec = {"metric": "ba_weak_scaling", "devices": w,
               "obs_total": o, "obs_per_device": args.obs_per_device,
               "platform": args.platform,
               "wall_s": round(best, 4),
               "note": ("same shard_map program at every width, fixed "
                        "per-device observations; the falsifiable "
                        "claim is AT-MOST-LINEAR wall growth from "
                        "width 1 to max width (flat when cores >= "
                        "devices). Super-linear growth — e.g. wall(8) "
                        "> 1.3 * 8 * wall(1) — means a collective "
                        "graph whose cost scales with width, and "
                        "fails this artifact.")}
        out["weak_scaling"].append(rec)
        print(json.dumps(rec))
    walls = {r["devices"]: r["wall_s"] for r in out["weak_scaling"]}
    # machine-independent falsifiable bound: at most linear growth
    # from the same-program width-1 row to the widest row. On a
    # many-core box (or real chips) wall stays ~flat; with fewer cores
    # than virtual devices work serializes and wall grows ~linearly; a
    # width-scaling collective graph is super-linear on either host.
    wmax = max(widths)
    out["weak_scaling_claim_at_most_linear"] = bool(
        walls[wmax] <= 1.3 * (wmax / 1) * walls[1])

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    ok = (out["census"]["obs_sharded_claims"]["op_count_width_independent"]
          and out["census"]["obs_sharded_claims"][
              "byte_volume_width_independent"]
          and out["census"]["point_sharded_claims"][
              "op_count_width_independent"]
          and out["census"]["point_lt_obs_bytes"]
          and out["weak_scaling_claim_at_most_linear"])
    return 0 if ok else 1


def _timed(fn) -> float:
    t0 = time.perf_counter()
    np.asarray(fn().cameras)
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())
