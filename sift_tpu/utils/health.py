"""Failure detection + recovery helpers (aux subsystem, SURVEY.md §5).

The reference's only failure handling is exit(0) on a bad image read.
Production multi-device runs need: NaN/divergence detection on device
state, a restartable BA wrapper (re-run with stronger damping instead
of propagating a diverged solve), and a mesh health check (every
device proves liveness through one tiny collective).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sift_tpu.sfm.ba import BAProblem, bundle_adjust, reproj_rmse


def tree_all_finite(tree) -> bool:
    """Host-side finiteness check over a pytree of arrays."""
    for leaf in jax.tree_util.tree_leaves(tree):
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            return False
    return True


def assert_finite(tree, name: str = "state") -> None:
    if not tree_all_finite(tree):
        raise FloatingPointError(f"non-finite values in {name}")


def mesh_health_check(mesh, timeout_s: float = 30.0) -> bool:
    """True iff every device in the mesh answers a psum within the
    deadline.

    One scalar all-reduce over the first mesh axis; a detached device
    fails the count, and a HUNG collective fails the deadline — the
    host pull runs in a daemon thread so this call always returns
    within ~timeout_s even when the device never does.

    A False return does NOT distinguish "a chip detached" from "the
    backend is wedged": on timeout the hung collective is still
    running on the daemon thread and the runtime may stay wedged
    behind it, so retrying device work from the same process can
    block on the same wedge. Treat False as 'this process's view of
    the mesh is unusable' — restart the process (the north-star
    recovery unit) rather than retrying in place.
    """
    import threading

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    axis = mesh.axis_names[0]
    n = mesh.devices.size

    def one(x):
        return jax.lax.psum(x, axis)

    fn = shard_map(one, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
                   check_vma=False)

    result: list = []

    def pull():
        out = jax.jit(fn)(jnp.ones((n,), jnp.float32))
        result.append(bool(np.all(np.asarray(out) == n)))

    t = threading.Thread(target=pull, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result) and result[0]


def bundle_adjust_restartable(prob: BAProblem, iters: int = 20,
                              cg_iters: int = 30,
                              huber_delta: float = 3e-3,
                              loss: str = "huber",
                              max_restarts: int = 2
                              ) -> Tuple[BAProblem, int]:
    """BA that detects a diverged/non-finite result and retries with
    10x damping from the last good state. Returns (result, restarts)."""
    lam0 = 1e-3
    rmse_in = float(np.asarray(reproj_rmse(prob)))
    for attempt in range(max_restarts + 1):
        out = bundle_adjust(prob, iters=iters, cg_iters=cg_iters,
                            huber_delta=huber_delta, loss=loss,
                            lam0=lam0)
        rmse_out = float(np.asarray(reproj_rmse(out)))
        if tree_all_finite((out.cameras, out.points)) and \
                np.isfinite(rmse_out) and rmse_out <= rmse_in * 1.001:
            return out, attempt
        lam0 *= 100.0
    return prob, max_restarts + 1   # give up: return last good state

