"""DCN-spanning partitioned pose-graph optimization.

The north-star multi-host scaling axis for long trajectories
(BASELINE.json config 5): poses are partitioned into contiguous
keyframe blocks, one block per host/device. Each round, every block
runs damped Gauss-Newton on its LOCAL subgraph (its own poses free,
halo poses — the far endpoints of boundary edges — frozen at the
current global estimate), then blocks exchange updated poses with one
`psum` over the mesh axis. That is nonlinear block-Jacobi: per round
the bytes on the wire are O(V * 6) floats — independent of edge
count, which stays local. Converges to the same optimum as the dense
single-host solver on graphs whose coupling is mostly local
(trajectory chains + sparse loop closures), which is exactly the
keyframe regime.

The reference has no distributed anything (SURVEY.md §5 — single
process, OpenMP threads); this capability is new, mandated by the
north star. Partitioning happens host-side in NumPy (static shapes:
every block is padded to the same local vertex/edge capacity);
the per-round compute + exchange runs under shard_map so the same
code drives a virtual CPU mesh, the GPUs of one host, or
multi-process DCN deployments (tests/_dist_worker.py runs it across
a real process boundary).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sift_tpu.sfm.posegraph import (PoseGraph, optimize_pose_graph,
                                    pose_graph_cost)


class PartitionedGraph(NamedTuple):
    """Per-block local subgraphs, all padded to common capacities.

    gidx: (B, Vl) global vertex index of each local slot
    own:  (B, Vl) True where this block owns the vertex (vs halo)
    vmask:(B, Vl) slot holds a real vertex
    edges_i/j: (B, El) LOCAL endpoint indices
    rel:  (B, El, 6); weight: (B, El); emask: (B, El)
    fixed:(B, Vl) gauge-fixed OR halo (frozen during local solves)
    color:(B,) Gauss-Seidel schedule color: blocks sharing an edge
          never update in the same round (greedy coloring of the
          block-coupling graph — index parity alone misses
          loop-closure edges between same-parity blocks)
    """
    gidx: jnp.ndarray
    own: jnp.ndarray
    vmask: jnp.ndarray
    edges_i: jnp.ndarray
    edges_j: jnp.ndarray
    rel: jnp.ndarray
    weight: jnp.ndarray
    emask: jnp.ndarray
    fixed: jnp.ndarray
    color: jnp.ndarray


def partition_pose_graph(g: PoseGraph, n_blocks: int) -> PartitionedGraph:
    """Contiguous-range partition (host-side NumPy).

    Keyframe trajectories are index-ordered, so contiguous ranges give
    low edge cut; loop-closure edges become boundary edges with halo
    vertices.
    """
    v = int(g.poses.shape[0])
    ei = np.asarray(g.edges_i)
    ej = np.asarray(g.edges_j)
    emask = np.asarray(g.mask)
    fixed = np.asarray(g.fixed)
    block_of = np.minimum(np.arange(v) * n_blocks // v, n_blocks - 1)

    locals_ = []
    for b in range(n_blocks):
        owned = np.where(block_of == b)[0]
        touching = [k for k in range(len(ei))
                    if emask[k] and (block_of[ei[k]] == b
                                     or block_of[ej[k]] == b)]
        halo = sorted((set(int(ei[k]) for k in touching)
                       | set(int(ej[k]) for k in touching))
                      - set(owned.tolist()))
        verts = np.concatenate([owned, np.array(halo, int)]) \
            if halo else owned
        locals_.append((owned, verts, touching))

    # greedy coloring of the block-coupling graph: blocks linked by any
    # edge (incl. loop closures) must not update simultaneously
    adj = {b: set() for b in range(n_blocks)}
    for k in range(len(ei)):
        if emask[k]:
            a, b = int(block_of[ei[k]]), int(block_of[ej[k]])
            if a != b:
                adj[a].add(b)
                adj[b].add(a)
    colors = np.zeros(n_blocks, np.int32)
    for b in range(n_blocks):
        used = {int(colors[nb]) for nb in adj[b] if nb < b}
        col = 0
        while col in used:
            col += 1
        colors[b] = col

    vl = max(len(vv) for _, vv, _ in locals_)
    el = max(max(len(tt) for _, _, tt in locals_), 1)

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    gidx, own, vmask, lei, lej, rel, wgt, lem, lfix = \
        [], [], [], [], [], [], [], [], []
    rel_np = np.asarray(g.rel)
    w_np = np.asarray(g.weight)
    for owned, verts, touching in locals_:
        remap = {int(gv): i for i, gv in enumerate(verts)}
        nvert = len(verts)
        gidx.append(pad(verts.astype(np.int32), vl))
        own.append(pad(np.arange(nvert) < len(owned), vl, False))
        vmask.append(pad(np.ones(nvert, bool), vl, False))
        lei.append(pad(np.array([remap[int(ei[k])] for k in touching],
                                np.int32), el))
        lej.append(pad(np.array([remap[int(ej[k])] for k in touching],
                                np.int32), el))
        rel.append(pad(rel_np[touching].astype(np.float32), el))
        wgt.append(pad(w_np[touching].astype(np.float32), el))
        lem.append(pad(np.ones(len(touching), bool), el, False))
        # halo + padding slots are frozen; gauge-fixed stay fixed
        f = np.array([fixed[int(gv)] or i >= len(owned)
                      for i, gv in enumerate(verts)], bool)
        lfix.append(pad(f, vl, True))

    stack = lambda xs: jnp.asarray(np.stack(xs))
    return PartitionedGraph(
        gidx=stack(gidx), own=stack(own), vmask=stack(vmask),
        edges_i=stack(lei), edges_j=stack(lej), rel=stack(rel),
        weight=stack(wgt), emask=stack(lem), fixed=stack(lfix),
        color=jnp.asarray(colors))


def optimize_pose_graph_partitioned(
        g: PoseGraph, mesh: Mesh, rounds: int | None = None,
        inner_iters: int = 6, lam0: float = 1e-4) -> PoseGraph:
    """Block-Jacobi pose-graph refinement over a mesh (see module doc).

    The mesh's first axis size must equal the number of blocks; each
    device runs one block's local Gauss-Newton per round, then blocks
    exchange owned poses with a single psum.

    `rounds` defaults to 3 * n_blocks * n_colors: corrections
    propagate roughly one block per color cycle under the Gauss-Seidel
    schedule, so the round count must comfortably exceed the block
    count (a fixed small default silently under-converges on meshes
    with many blocks).
    """
    axis = mesh.axis_names[0]
    n_blocks = mesh.shape[axis]
    part = partition_pose_graph(g, n_blocks)
    # static color count: rounds cycle through the schedule colors
    n_colors = int(np.asarray(part.color).max()) + 1
    if rounds is None:
        rounds = max(6, 3 * n_blocks * n_colors)
    v = g.poses.shape[0]

    def local_rounds(poses, pt: PartitionedGraph):
        # shard_map gives leading-dim-1 blocks; drop it
        pt = jax.tree_util.tree_map(lambda x: x[0], pt)

        def one_round(i, poses):
            local = poses[pt.gidx]                        # (Vl, 6)
            sub = PoseGraph(poses=local, edges_i=pt.edges_i,
                            edges_j=pt.edges_j, rel=pt.rel,
                            weight=pt.weight, mask=pt.emask,
                            fixed=pt.fixed)
            sub = optimize_pose_graph(sub, iters=inner_iters,
                                      lam0=lam0)
            # Gauss-Seidel color schedule: edge-coupled blocks never
            # update in the same round (simultaneous Jacobi updates of
            # coupled blocks oscillate and stall); colors come from a
            # greedy coloring of the block-coupling graph, so loop-
            # closure couplings are respected too, not just the chain
            active = (pt.color == (i % n_colors)).astype(jnp.float32)
            ownf = (pt.own & pt.vmask).astype(jnp.float32)[:, None] \
                * active
            contrib = jnp.zeros((v, 6), jnp.float32).at[pt.gidx].add(
                sub.poses * ownf)
            cnt = jnp.zeros((v,), jnp.float32).at[pt.gidx].add(
                ownf[:, 0])
            total = jax.lax.psum(contrib, axis)
            cnt = jax.lax.psum(cnt, axis)
            return jnp.where(cnt[:, None] > 0, total
                             / jnp.maximum(cnt[:, None], 1.0), poses)

        return jax.lax.fori_loop(0, rounds, one_round, poses)

    specs = PartitionedGraph(*([P(axis)] * len(part._fields)))
    fn = shard_map(local_rounds, mesh=mesh, in_specs=(P(), specs),
                   out_specs=P(), check_vma=False)
    poses = jax.jit(fn)(g.poses.astype(jnp.float32), part)
    return g._replace(poses=poses)


def selftest(mesh: Mesh) -> None:
    """Convergence check runnable on any mesh (used by the
    multi-process worker and the virtual-mesh unit test): a noisy
    loop trajectory must optimize to near the dense solver's cost."""
    rng = np.random.default_rng(7)
    nv = 4 * mesh.shape[mesh.axis_names[0]]
    true = np.zeros((nv, 6), np.float32)
    true[:, 1] = np.linspace(0, 1.2, nv)                  # slow yaw
    true[:, 3] = np.arange(nv) * 0.5                      # x walk
    ei, ej, rel = [], [], []
    from sift_tpu.geometry.lie import so3_exp, so3_log
    for i in range(nv - 1):
        pairs = [(i, i + 1)]
        if i % 5 == 0 and i + 3 < nv:
            pairs.append((i, i + 3))                      # loop edges
        for a, b in pairs:
            ra = np.asarray(so3_exp(jnp.asarray(true[a, :3])))
            rb = np.asarray(so3_exp(jnp.asarray(true[b, :3])))
            rr = ra.T @ rb
            tt = ra.T @ (true[b, 3:] - true[a, 3:])
            w = np.asarray(so3_log(jnp.asarray(rr)))
            ei.append(a)
            ej.append(b)
            rel.append(np.concatenate([w + rng.normal(0, 1e-3, 3),
                                       tt + rng.normal(0, 1e-3, 3)]))
    e = len(ei)
    init = true + rng.normal(0, 0.05, true.shape).astype(np.float32)
    init[0] = true[0]
    g = PoseGraph(
        poses=jnp.asarray(init, jnp.float32),
        edges_i=jnp.asarray(np.array(ei, np.int32)),
        edges_j=jnp.asarray(np.array(ej, np.int32)),
        rel=jnp.asarray(np.array(rel, np.float32)),
        weight=jnp.ones((e,), jnp.float32),
        mask=jnp.ones((e,), bool),
        fixed=jnp.asarray(np.arange(nv) == 0))
    c0 = float(pose_graph_cost(g))
    dense = optimize_pose_graph(g, iters=20)
    cd = float(pose_graph_cost(dense))
    # gauge corrections propagate ~one block per round (block-Jacobi),
    # so rounds must comfortably exceed the block count
    partd = optimize_pose_graph_partitioned(g, mesh, rounds=24,
                                            inner_iters=6)
    cp = float(pose_graph_cost(partd))
    assert cd < c0 * 0.05, (c0, cd)
    assert cp < c0 * 0.02, (c0, cd, cp)
