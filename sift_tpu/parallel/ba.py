"""Distributed Schur-complement bundle adjustment over a device mesh.

The observation table is sharded over the mesh "data" axis; cameras
and points stay replicated. Because the single-chip adjuster (sfm/ba)
is matrix-free — every cross-observation reduction is a segment-sum —
distribution is exactly: do local segment-sums over the observation
shard, then psum the (C,6,6)/(P,3,3)/(C,6)/(P,3) block tensors over
the interconnect. Every device then computes the identical LM/CG update, keeping
the replicated state in lockstep with zero further communication.

Per LM iteration the bytes on the wire are O(C*36 + P*9) floats times
(2 + cg_iters) — independent of the observation count, which is where
the data lives. That is the Schur-reduction property the north star
asks to carry over ICI.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

import numpy as np

from sift_tpu.sfm.ba import BAProblem, bundle_adjust_loop
from sift_tpu.utils.caps import pow2_cap


def bundle_adjust_sharded(prob: BAProblem, mesh: Mesh,
                          iters: int = 20, cg_iters: int = 30,
                          huber_delta: float = 3e-3,
                          loss: str = "huber",
                          lam0: float = 1e-3) -> BAProblem:
    """Observation-sharded BA. The observation count O must be a
    multiple of the mesh "data" axis size (pad with mask=False)."""
    axis = mesh.axis_names[0]

    def local(prob_local: BAProblem) -> BAProblem:
        psum = functools.partial(jax.lax.psum, axis_name=axis)
        return bundle_adjust_loop(prob_local, iters, cg_iters,
                                  huber_delta, loss, lam0, psum=psum)

    obs_spec = P(axis)
    rep = P()
    in_specs = BAProblem(cameras=rep, points=rep, cam_idx=obs_spec,
                         pt_idx=obs_spec, uv=obs_spec, mask=obs_spec,
                         fixed_cams=rep)
    out_specs = BAProblem(cameras=rep, points=rep, cam_idx=obs_spec,
                          pt_idx=obs_spec, uv=obs_spec, mask=obs_spec,
                          fixed_cams=rep)
    fn = shard_map(local, mesh=mesh, in_specs=(in_specs,),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)(prob)


def bundle_adjust_point_sharded(prob: BAProblem, mesh: Mesh,
                                iters: int = 20, cg_iters: int = 30,
                                huber_delta: float = 3e-3,
                                loss: str = "huber",
                                lam0: float = 1e-3) -> BAProblem:
    """Map-block-sharded BA: POINTS partitioned across the mesh.

    The observation-sharded adjuster replicates the whole map on every
    device — fine for moderate maps, impossible at map scale (config
    5: 10^6+ points on a pod). Here each device owns a contiguous
    point block plus exactly the observations of its points
    (partitioned host-side below); point-side normal-equation blocks,
    Hpp^-1 back-substitution and point updates are fully LOCAL, and
    only the (C,6,6)/(C,6) camera system crosses the mesh per CG
    step — wire bytes O(C*36), independent of both observation and
    point count.

    Returns `prob` with updated cameras/points (original ordering).
    """
    fn = _point_sharded_device_fn(mesh, iters, cg_iters, huber_delta,
                                  loss, lam0)
    inputs, p_total = point_sharded_inputs(prob, mesh)
    cams_out, pts_out = jax.jit(fn)(*inputs)
    return prob._replace(cameras=cams_out,
                         points=pts_out[:p_total])


def point_sharded_inputs(prob: BAProblem, mesh: Mesh):
    """Host-side partition of a BAProblem into contiguous point blocks
    (one per device) for the point-sharded adjuster. Returns
    (device_fn_args, n_points). Exposed so bench_scaling.py can lower
    the device function for the collective census."""
    n = mesh.shape[mesh.axis_names[0]]
    pt_idx = np.asarray(prob.pt_idx)
    cam_idx = np.asarray(prob.cam_idx)
    uv = np.asarray(prob.uv)
    mask = np.asarray(prob.mask)
    points = np.asarray(prob.points)
    p_total = points.shape[0]
    pp = -(-p_total // n)                     # points per block
    pts_pad = np.zeros((pp * n, 3), points.dtype)
    pts_pad[:p_total] = points
    block_of = np.minimum(pt_idx // pp, n - 1)
    counts = [(mask & (block_of == b)).sum() for b in range(n)]
    ocap = pow2_cap(max(counts), lo=64)
    l_cam = np.zeros((n, ocap), np.int32)
    l_pt = np.zeros((n, ocap), np.int32)
    l_uv = np.zeros((n, ocap, 2), np.float32)
    l_mask = np.zeros((n, ocap), bool)
    for b in range(n):
        sel = np.where(mask & (block_of == b))[0][:ocap]
        k = len(sel)
        l_cam[b, :k] = cam_idx[sel]
        l_pt[b, :k] = pt_idx[sel] - b * pp    # local point index
        l_uv[b, :k] = uv[sel]
        l_mask[b, :k] = True
    inputs = (prob.cameras, prob.fixed_cams,
              jnp.asarray(pts_pad.reshape(n, pp, 3)),
              jnp.asarray(l_cam), jnp.asarray(l_pt),
              jnp.asarray(l_uv), jnp.asarray(l_mask))
    return inputs, p_total


def _point_sharded_device_fn(mesh: Mesh, iters: int, cg_iters: int,
                             huber_delta: float, loss: str,
                             lam0: float):
    axis = mesh.axis_names[0]

    def local(cameras, fixed, pts_l, cam_i, pt_i, uv_l, m_l):
        psum = functools.partial(jax.lax.psum, axis_name=axis)
        sub = BAProblem(cameras=cameras, points=pts_l[0],
                        cam_idx=cam_i[0], pt_idx=pt_i[0], uv=uv_l[0],
                        mask=m_l[0], fixed_cams=fixed)
        out = bundle_adjust_loop(sub, iters, cg_iters, huber_delta,
                                 loss, lam0, psum=psum, psum_pt=None)
        # one final all_gather replicates the solved map so callers
        # (incl. multi-process ones) can fetch it without cross-host
        # addressability gymnastics; O(P) bytes once, not per step
        pts_all = jax.lax.all_gather(out.points, axis)     # (n, pp, 3)
        return out.cameras, pts_all.reshape(-1, 3)

    sh = P(axis)
    return shard_map(local, mesh=mesh,
                     in_specs=(P(), P(), sh, sh, sh, sh, sh),
                     out_specs=(P(), P()), check_vma=False)
