"""Geometry/BA precision: every float32 product on the geometry and SfM
path is pinned to full precision (a GPU may otherwise pick TF32), and
the pinned solvers agree with float64 NumPy."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.extend import core as jex_core

from sift_tpu import smoke
from sift_tpu.geometry import find_homography_ransac, perspective_transform
from sift_tpu.sfm import bundle_adjust, reproj_rmse
from sift_tpu.synth import project

HI = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a closed jaxpr,
    sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _all_highest(precisions):
    return precisions and all(
        p is not None and tuple(p) == (HI, HI) for p in precisions)


def test_homography_products_pinned_highest():
    src = jnp.zeros((64, 2), jnp.float32)
    jx = jax.make_jaxpr(find_homography_ransac)(src, src)
    assert _all_highest(_dot_precisions(jx.jaxpr))


def test_bundle_adjust_products_pinned_highest():
    prob = smoke.ba_problem(np.random.default_rng(0), 4, 50)
    jx = jax.make_jaxpr(bundle_adjust)(prob)
    assert _all_highest(_dot_precisions(jx.jaxpr))


@pytest.mark.parametrize("seed", [0, 1])
def test_homography_vs_float64_dlt(seed):
    rng = np.random.default_rng(seed)
    _, src, dst = smoke.homography_case(rng, 256)
    res = find_homography_ransac(src, dst)
    inl = np.asarray(res.inliers)
    h64 = smoke._dlt64(src[inl].astype(np.float64),
                       dst[inl].astype(np.float64))
    sq = np.array([[0, 0], [800, 0], [800, 800], [0, 800]], np.float32)
    got = np.asarray(perspective_transform(sq, res.H))
    assert np.abs(got - project(h64, sq.astype(np.float64))).max() \
        <= smoke.HOMOGRAPHY_CORNER_TOL_PX


def test_bundle_adjust_vs_float64_least_squares():
    """BA converges to the float64 optimum of the same problem
    (scipy least_squares on the same residuals, first camera fixed).
    Fixing one camera leaves the monocular scale free, so cameras are
    compared by rotation; the reprojection error fixes the rest."""
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    prob = smoke.ba_problem(np.random.default_rng(3), 5, 120)
    out = bundle_adjust(prob, iters=30)
    ci = np.asarray(prob.cam_idx)
    pi = np.asarray(prob.pt_idx)
    uv = np.asarray(prob.uv, np.float64)
    cams0 = np.asarray(prob.cameras, np.float64)
    n_c, n_p = cams0.shape[0], np.asarray(prob.points).shape[0]

    def resid(x):
        cams = np.concatenate([cams0[:1], x[:(n_c - 1) * 6].reshape(-1, 6)])
        pts = x[(n_c - 1) * 6:].reshape(n_p, 3)
        r = Rotation.from_rotvec(cams[ci, :3]).as_matrix()
        xc = np.einsum("oij,oj->oi", r, pts[pi]) + cams[ci, 3:]
        return (xc[:, :2] / xc[:, 2:3] - uv).ravel()

    x0 = np.concatenate([cams0[1:].ravel(),
                         np.asarray(prob.points, np.float64).ravel()])
    sol = least_squares(resid, x0, method="lm", xtol=1e-12, ftol=1e-12)
    rmse64 = np.sqrt(np.mean(sol.fun.reshape(-1, 2) ** 2) * 2)
    rmse32 = float(reproj_rmse(out))
    assert abs(rmse32 - rmse64) <= 0.01 * rmse64, (rmse32, rmse64)
    cams64 = sol.x[:(n_c - 1) * 6].reshape(-1, 6)
    assert np.abs(np.asarray(out.cameras)[1:, :3] - cams64[:, :3]).max() \
        <= 1e-4
