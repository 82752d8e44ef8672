"""Card lane: the smoke phases (sift_tpu/smoke.py) at their real sizes,
on the GPU. Each test skips without a GPU; the decision is made inside
the `gpu` fixture, never while the module is imported. On the card:

    SIFT_GPU_TESTS=1 python -m pytest tests/test_gpu.py -q
"""

import pytest

from sift_tpu import smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (SIFT_GPU_TESTS=1 on the card)")
    return jax.devices()


def test_pipeline_1080p(gpu):
    smoke.phase_pipeline(n_warm=3)


def test_parity_vs_cpu_and_oracle(gpu):
    smoke.phase_parity()


def test_geometry_and_ba_precision(gpu):
    smoke.phase_precision()


def test_four_cards(gpu):
    if len(gpu) < 4:
        pytest.skip("needs four GPUs")
    smoke.phase_four_cards(4)
