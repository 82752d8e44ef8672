"""chip_smoke.py's contract without a card: it refuses a CPU-only
process and a checkout-less directory, and prints no result line;
the device check and compile-cache policy it shares with bench.py and
the CLI."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from sift_tpu.utils import compile_cache, device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return bool(json.loads(lines[-1]).get("ok"))
    except (ValueError, AttributeError):
        return False


def test_chip_smoke_refuses_cpu_only_process():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert not _printed_ok(r.stdout)
    assert "NoGPUError" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert not _printed_ok(r.stdout)


def test_select_platform_gpu_refuses_cpu():
    with pytest.raises(device.NoGPUError):
        device.select_platform("gpu")
    with pytest.raises(ValueError):
        device.select_platform("rocm")


def test_bench_refuses_cpu_by_default():
    sys.path.insert(0, REPO)
    try:
        import bench
        with pytest.raises(device.NoGPUError):
            bench.main([])
    finally:
        sys.path.remove(REPO)


def test_device_stamp_names_the_device():
    stamp = device.device_stamp()
    assert stamp["platform"] == "cpu" and stamp["count"] == len(
        jax.devices())
    assert "kind" in stamp and "nvidia_smi" in stamp


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # with the variable set, nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_dir_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.enable_compile_cache(min_compile_secs=0.5)
    assert got == compile_cache.REPO_CACHE_DIR
    assert os.path.dirname(got) == REPO
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_lands_in_env_dir(tmp_path):
    code = ("from sift_tpu.utils.compile_cache import enable_compile_cache;"
            "enable_compile_cache();"
            "import jax, jax.numpy as jnp;"
            "jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((64, 64)))"
            ".block_until_ready()")
    r = _run(["-c", code], REPO, {
        compile_cache.ENV_VAR: str(tmp_path),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert any(os.scandir(tmp_path)), "no cache entry written"
