"""The smoke phases (sift_tpu/smoke.py) at tiny sizes on the CPU: the
same functions chip_smoke.py runs on the card at full size. Here the
"card" is the CPU device, so these check control flow, pairing and
tolerance logic, not the card."""

import numpy as np
import pytest

from sift_tpu import smoke


def test_phase_device_checks_platform():
    assert smoke.phase_device("cpu")["platform"] == "cpu"
    with pytest.raises(smoke.SmokeFailure):
        smoke.phase_device("gpu")


def test_phase_pipeline_tiny():
    out = smoke.phase_pipeline(scene_hw=(360, 480), obj_hw=(120, 160),
                               n_warm=1, kp_range=(50, 5000))
    assert out["found"] and out["corner_err_px"] <= smoke.CORNER_TOL_PX
    assert out["latency"]["n"] == 1


def test_phase_precision_tiny():
    out = smoke.phase_precision(n_corr=256, n_cams=6, n_pts=300,
                                ba_iters=10)
    assert out["ba"]["rmse_acc"] < out["ba"]["rmse_start"]


def test_pair_points_uses_angle():
    a = np.array([[10.0, 5.0, 30.0], [10.0, 5.0, 200.0]])
    b = np.array([[10.0, 5.0, 200.0005], [10.0004, 5.0, 29.999]])
    np.testing.assert_array_equal(smoke._pair_points(a, b, 1e-3), [1, 0])
    np.testing.assert_array_equal(
        smoke._pair_points(a, b[:1] + [0.01, 0, 0], 1e-3), [-1, -1])


def test_smoke_check_raises():
    smoke.check(True, "fine")
    with pytest.raises(smoke.SmokeFailure):
        smoke.check(False, "a miss")
