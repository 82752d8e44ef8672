"""Pose-graph optimization over SE(3) (north-star capability).

Gauss-Newton on relative-pose constraints: given edges (i, j) with
measured relative transforms T_ij, minimize
  sum_e || log( T_ij^-1 · T_i^-1 · T_j ) ||^2_W
over absolute poses T_i (first pose fixed as gauge). Batched: a
static masked edge table; per-EDGE 6x6 Jacobian blocks via vmapped
jacfwd (O(E) work/memory) scatter-added into the (6V x 6V) normal
equations — never the dense (6E x 6V) whole-problem Jacobian, whose
jacfwd cost is quadratic in trajectory length. The damped normal
solve itself is dense: pose graphs are small next to BA and a (6V)^2
solve is cheap dense work up to thousands of vertices; beyond that,
sfm/posegraph_dist.py partitions the graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sift_tpu.geometry.lie import so3_exp, so3_log
from sift_tpu.utils.precision import highest_precision


class PoseGraph(NamedTuple):
    """poses: (V, 6) [w|t] world->frame transforms.
    edges_i/j: (E,) int32; rel: (E, 6) measured T_i->T_j as [w|t];
    weight: (E,) edge information weight; mask: (E,) bool;
    fixed: (V,) bool gauge mask."""
    poses: jnp.ndarray
    edges_i: jnp.ndarray
    edges_j: jnp.ndarray
    rel: jnp.ndarray
    weight: jnp.ndarray
    mask: jnp.ndarray
    fixed: jnp.ndarray


@highest_precision
def _compose_inv_ab(a6, b6):
    """log-ish residual of T_a^-1 T_b vs identity, as (R, t) pieces."""
    ra = so3_exp(a6[:3])
    rb = so3_exp(b6[:3])
    r = ra.T @ rb
    t = ra.T @ (b6[3:] - a6[3:])
    return r, t


@highest_precision
def _edge_residual(pose_i, pose_j, rel6):
    """6-vector residual of one edge."""
    # predicted relative: T_i^-1 T_j
    r_pred, t_pred = _compose_inv_ab(pose_i, pose_j)
    r_meas = so3_exp(rel6[:3])
    dr = r_meas.T @ r_pred
    dt = r_meas.T @ (t_pred - rel6[3:])
    return jnp.concatenate([so3_log(dr), dt])


def _edge_jacobians(pose_i, pose_j, rel6):
    """Per-edge (6, 6) residual Jacobians wrt each endpoint."""
    ji = jax.jacfwd(_edge_residual, 0)(pose_i, pose_j, rel6)
    jj = jax.jacfwd(_edge_residual, 1)(pose_i, pose_j, rel6)
    return ji, jj


@functools.partial(jax.jit, static_argnames=("iters",))
@highest_precision
def optimize_pose_graph(g: PoseGraph, iters: int = 15,
                        lam0: float = 1e-4) -> PoseGraph:
    """Damped Gauss-Newton with accept/reject on the total cost.

    Normal equations assemble in O(E): vmapped per-edge 6x6 Jacobian
    blocks scatter-added into H (the sfm/ba.py segment-sum pattern);
    the old whole-problem jacfwd built a (6E x 6V) Jacobian whose
    construction cost grew quadratically with trajectory length.
    """
    v = g.poses.shape[0]
    wm = (g.weight * g.mask.astype(jnp.float32))
    sqw = jnp.sqrt(wm)
    freev = (~g.fixed).astype(jnp.float32)
    free_flat = jnp.repeat(freev, 6)
    fixed_flat = 1.0 - free_flat

    def cost(poses):
        res = jax.vmap(_edge_residual)(
            poses[g.edges_i], poses[g.edges_j], g.rel)
        return jnp.sum(res * res * wm[:, None])

    def body(_, carry):
        poses, lam = carry
        pi, pj = poses[g.edges_i], poses[g.edges_j]
        r = jax.vmap(_edge_residual)(pi, pj, g.rel)         # (E, 6)
        ji, jj = jax.vmap(_edge_jacobians)(pi, pj, g.rel)   # (E, 6, 6)
        # weight + gauge: fixed endpoints contribute no columns
        ji = ji * (sqw * freev[g.edges_i])[:, None, None]
        jj = jj * (sqw * freev[g.edges_j])[:, None, None]
        rw = r * sqw[:, None]
        ei, ej = g.edges_i, g.edges_j
        h = jnp.zeros((v, 6, v, 6), jnp.float32)
        h = h.at[ei, :, ei, :].add(jnp.einsum("era,erb->eab", ji, ji))
        h = h.at[ej, :, ej, :].add(jnp.einsum("era,erb->eab", jj, jj))
        hij = jnp.einsum("era,erb->eab", ji, jj)
        h = h.at[ei, :, ej, :].add(hij)
        h = h.at[ej, :, ei, :].add(jnp.swapaxes(hij, 1, 2))
        b = jnp.zeros((v, 6), jnp.float32)
        b = b.at[ei].add(jnp.einsum("era,er->ea", ji, rw))
        b = b.at[ej].add(jnp.einsum("era,er->ea", jj, rw))
        hd = h.reshape(6 * v, 6 * v)
        damped = hd + jnp.diag(
            lam * jnp.maximum(jnp.diag(hd), 1e-8) + fixed_flat)
        delta = jnp.linalg.solve(damped, b.reshape(-1)) * free_flat
        cand = poses - delta.reshape(v, 6)
        accept = (cost(cand) < cost(poses)) & \
            jnp.all(jnp.isfinite(cand))
        new = jnp.where(accept, cand, poses)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 4.0, 1e3))
        return new, lam

    poses, _ = jax.lax.fori_loop(
        0, iters, body, (g.poses.astype(jnp.float32),
                         jnp.float32(lam0)))
    return g._replace(poses=poses)


def pose_graph_cost(g: PoseGraph) -> jnp.ndarray:
    res = jax.vmap(_edge_residual)(
        g.poses[g.edges_i], g.poses[g.edges_j], g.rel)
    w = (g.weight * g.mask.astype(jnp.float32))[:, None]
    return jnp.sum(res * res * w)
