"""Elastic recovery: supervised, checkpointed BA with shrink-on-failure
restarts (aux subsystem, SURVEY.md §5 — the reference's only failure
handling is exit(0) on a bad image read).

`utils.health.mesh_health_check` DETECTS a dead or wedged mesh
participant, but in-process recovery is impossible: a JAX process
cannot drop devices from a live backend, so the north-star recovery
unit is the PROCESS. This module supplies that unit:

  * worker (this module run with ``--worker``): loads the latest
    checkpoint (or the initial problem), runs the observation-sharded
    Schur/CG BA in chunks over every device it can see, writes a
    checkpoint after each chunk, exits 0 when the iteration budget is
    done. Divergence (non-finite state) exits nonzero BEFORE
    checkpointing, so a poisoned state is never persisted.
  * ``supervise_ba``: spawns the worker, and on ANY nonzero exit —
    crash, SIGKILL from the outside, injected fault, lost host —
    respawns it over a SHRUNKEN device set (halved per failure, floor
    ``min_devices``), resuming from the last good checkpoint. Progress
    is monotone: a failed incarnation costs at most one chunk.

Fault injection for tests: ``inject_crash_step`` makes the FIRST
incarnation kill itself (os._exit) right after checkpointing that
step, exercising the real kill -> shrink -> resume path across a real
process boundary (tests/test_elastic.py also SIGKILLs a live worker).

The worker runs on the CPU: the supervisor pins the visible device
count via ``--xla_force_host_platform_device_count`` to simulate
shrink. It has not run on GPUs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Optional, Tuple


def _worker_main(args) -> int:
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.devices}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sift_tpu.parallel import make_mesh
    from sift_tpu.parallel.ba import bundle_adjust_sharded
    from sift_tpu.sfm import checkpoint as ck
    from sift_tpu.utils.health import tree_all_finite

    last = ck.latest(args.ckpt_dir)
    if last is not None:
        prob, step = ck.load_ba(last)
    else:
        prob, step = ck.load_ba(args.problem)
    n = len(jax.devices())
    mesh = make_mesh((n,), ("data",))
    print(f"ELASTIC_WORKER devices={n} resume_step={step}", flush=True)
    while step < args.total_iters:
        k = min(args.chunk_iters, args.total_iters - step)
        out = bundle_adjust_sharded(prob, mesh, iters=k,
                                    cg_iters=args.cg_iters)
        if not tree_all_finite((out.cameras, out.points)):
            print("ELASTIC_DIVERGED", flush=True)
            return 3                      # do not checkpoint poison
        step += k
        ck.save_ba_step(args.ckpt_dir, out, step)
        print(f"ELASTIC_CHUNK step={step}", flush=True)
        prob = out
        if args.crash_after_step is not None \
                and step >= args.crash_after_step:
            os._exit(17)                  # injected fault (tests)
    print(f"ELASTIC_DONE step={step}", flush=True)
    return 0


def supervise_ba(problem_path: str, ckpt_dir: str,
                 total_iters: int = 16, chunk_iters: int = 4,
                 cg_iters: int = 10,
                 n_devices: int = 8, min_devices: int = 1,
                 max_restarts: int = 4,
                 inject_crash_step: Optional[int] = None,
                 worker_timeout: float = 600.0,
                 on_spawn=None) -> Tuple[str, int]:
    """Run the elastic worker to completion; returns (final checkpoint
    path, restart count). ``on_spawn(popen)`` lets a test reach the
    live worker (e.g. to SIGKILL it)."""
    restarts = 0
    n = n_devices
    while True:
        cmd = [sys.executable, "-m", "sift_tpu.parallel.elastic",
               "--worker", "--problem", problem_path,
               "--ckpt-dir", ckpt_dir,
               "--total-iters", str(total_iters),
               "--chunk-iters", str(chunk_iters),
               "--cg-iters", str(cg_iters),
               "--devices", str(n)]
        if inject_crash_step is not None and restarts == 0:
            cmd += ["--crash-after-step", str(inject_crash_step)]
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)        # worker pins its own devices
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        p = subprocess.Popen(cmd, env=env, text=True,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if on_spawn is not None:
            on_spawn(p)
        try:
            out, _ = p.communicate(timeout=worker_timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out = "(timed out)"
        if p.returncode == 0:
            from sift_tpu.sfm import checkpoint as ck
            final = ck.latest(ckpt_dir)
            if final is None:
                raise RuntimeError("worker finished without checkpoint")
            return final, restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"elastic BA failed after {max_restarts} restarts; "
                f"last worker output:\n{out}")
        n = max(min_devices, n // 2)      # lost participant -> re-shard


def _parse(argv=None):
    ap = argparse.ArgumentParser(prog="sift_tpu.parallel.elastic")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--problem", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--total-iters", type=int, default=16,
                    dest="total_iters")
    ap.add_argument("--chunk-iters", type=int, default=4,
                    dest="chunk_iters")
    ap.add_argument("--cg-iters", type=int, default=10, dest="cg_iters")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--crash-after-step", type=int, default=None,
                    dest="crash_after_step")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _parse()
    if not a.worker:
        print("run with --worker (the supervisor is supervise_ba())",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(_worker_main(a))
