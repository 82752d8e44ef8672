"""Worker process for multi-process jax.distributed CPU tests.

Run as: python tests/_dist_worker.py <pid> <nproc> <port>

Each process owns 4 virtual CPU devices; together they form an
8-device global mesh spanning a process (≈host/DCN) boundary — the
multi-host execution pattern SURVEY.md §5 mandates, testable without
a pod. Both processes build identical NumPy inputs (same seed), wrap
them as global jax.Arrays (sharded observations / replicated state),
and run the real distributed code paths:

  * observation-sharded Schur/CG bundle adjustment (parallel/ba.py)
  * query-sharded descriptor matching (parallel/match.py)
  * DCN-style pose-graph partition refinement (sfm/posegraph_dist.py)

checking each against its single-device twin computed locally.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _global_array(x, mesh, spec):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, NamedSharding(mesh, spec), lambda idx: x[idx])


def _make_rig(rng, n_cams=6, n_pts=96, noise=1e-3):
    import numpy as np
    import jax.numpy as jnp
    from sift_tpu.geometry import lie
    from sift_tpu.sfm import BAProblem

    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 12, n_pts)], axis=1)
    cams = []
    for i in range(n_cams):
        w = np.array([0.0, (i - n_cams / 2) * 0.12, 0.0])
        r = np.asarray(lie.so3_exp(w))
        center = np.array([2.0 * i / n_cams - 1.0, 0.1 * i, 0.0])
        cams.append(np.concatenate([w, -r @ center]))
    cams = np.stack(cams)

    cam_idx, pt_idx, uv = [], [], []
    for ci in range(n_cams):
        r = np.asarray(lie.so3_exp(cams[ci, :3]))
        xc = pts @ r.T + cams[ci, 3:]
        proj = xc[:, :2] / xc[:, 2:3]
        for pi in range(n_pts):
            if rng.random() < 0.2:
                continue
            cam_idx.append(ci)
            pt_idx.append(pi)
            uv.append(proj[pi] + rng.normal(0, noise, 2))
    o = len(cam_idx)
    cap = 1 << int(np.ceil(np.log2(o)))
    pad = cap - o
    mask = np.array([True] * o + [False] * pad)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    cams0 = cams.copy()
    cams0[1:] += rng.normal(0, 0.03, cams0[1:].shape)
    pts0 = pts + rng.normal(0, 0.05, pts.shape)
    prob = dict(
        cameras=cams0.astype(np.float32), points=pts0.astype(np.float32),
        cam_idx=np.array(cam_idx + [0] * pad, np.int32),
        pt_idx=np.array(pt_idx + [0] * pad, np.int32),
        uv=np.array(uv + [[0.0, 0.0]] * pad, np.float32),
        mask=mask, fixed_cams=fixed)
    return prob


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    # pin CPU via config too (backends init lazily), exactly like
    # tests/conftest.py does: this worker never opens a GPU
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                               process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    assert jax.process_count() == nproc
    assert jax.device_count() == 4 * nproc, jax.devices()

    from sift_tpu.parallel import default_mesh
    from sift_tpu.parallel.ba import bundle_adjust_sharded
    from sift_tpu.parallel.match import sharded_match_ratio
    from sift_tpu.sfm import BAProblem, bundle_adjust, reproj_rmse
    from sift_tpu.ops import match as match_mod

    mesh = default_mesh()          # all 8 devices, both processes

    # --- distributed BA across the process boundary ---
    rig = _make_rig(np.random.default_rng(0))
    obs = P("data")
    rep = P()
    prob_g = BAProblem(
        cameras=_global_array(rig["cameras"], mesh, rep),
        points=_global_array(rig["points"], mesh, rep),
        cam_idx=_global_array(rig["cam_idx"], mesh, obs),
        pt_idx=_global_array(rig["pt_idx"], mesh, obs),
        uv=_global_array(rig["uv"], mesh, obs),
        mask=_global_array(rig["mask"], mesh, obs),
        fixed_cams=_global_array(rig["fixed_cams"], mesh, rep))
    out_s = bundle_adjust_sharded(prob_g, mesh, iters=12, cg_iters=30)

    prob_l = BAProblem(**{k: jnp.asarray(v) for k, v in rig.items()})
    out_l = bundle_adjust(prob_l, iters=12, cg_iters=30)
    # cross-process psum ordering perturbs the LM accept/reject path,
    # so parameters match only loosely; the real gate is that BOTH
    # converge to reprojection-noise level on the same problem
    np.testing.assert_allclose(np.asarray(out_s.cameras),
                               np.asarray(out_l.cameras),
                               rtol=0.05, atol=0.02)
    rmse_s = float(reproj_rmse(prob_l._replace(
        cameras=jnp.asarray(np.asarray(out_s.cameras)),
        points=jnp.asarray(np.asarray(out_s.points)))))
    assert rmse_s < 1.5e-3, rmse_s
    assert float(reproj_rmse(out_l)) < 1.5e-3
    print(f"[p{pid}] BA_OK", flush=True)

    # --- point-sharded (map-block) BA across the process boundary ---
    from sift_tpu.parallel.ba import bundle_adjust_point_sharded
    out_p = bundle_adjust_point_sharded(prob_l, mesh, iters=12,
                                        cg_iters=30)
    rmse_p = float(reproj_rmse(prob_l._replace(
        cameras=jnp.asarray(np.asarray(out_p.cameras)),
        points=jnp.asarray(np.asarray(out_p.points)))))
    assert rmse_p < 1.5e-3, rmse_p
    print(f"[p{pid}] BA_PT_OK", flush=True)

    # --- query-sharded matching across the process boundary ---
    rng = np.random.default_rng(1)

    def mkdesc(n):
        d = rng.random((n, 128)).astype(np.float32) ** 2
        d /= d.sum(axis=1, keepdims=True)
        return np.sqrt(d)

    q, t = mkdesc(256), mkdesc(512)
    ref = match_mod.match_ratio(jnp.asarray(q), jnp.asarray(t))
    out = sharded_match_ratio(_global_array(q, mesh, P("data")),
                              _global_array(t, mesh, rep), mesh)
    ref_good = np.asarray(ref.good)
    ref_ti = np.asarray(ref.train_idx)
    for shard in out.good.addressable_shards:
        s = shard.index[0]
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      ref_good[s])
    for shard in out.train_idx.addressable_shards:
        s = shard.index[0]
        np.testing.assert_array_equal(np.asarray(shard.data), ref_ti[s])
    print(f"[p{pid}] MATCH_OK", flush=True)

    # --- DCN-style partitioned pose-graph refinement ---
    from sift_tpu.sfm import posegraph_dist
    posegraph_dist.selftest(mesh)
    print(f"[p{pid}] POSEGRAPH_OK", flush=True)

    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
