"""Which device a run is on, stated in every result it prints.

A measurement or smoke path that expects a GPU fails when JAX finds
none; it never continues on the CPU. The CPU is used only when a
caller asks for it by name (rehearsal, tests).
"""

from __future__ import annotations

import subprocess
from typing import Optional

PLATFORMS = ("gpu", "cpu")


class NoGPUError(RuntimeError):
    """JAX found no GPU where one was required."""


def select_platform(platform: str) -> None:
    """Pin JAX to `platform` before any device use. "cpu" pins the CPU
    backend; "gpu" raises NoGPUError unless JAX's default device is a
    GPU."""
    import jax
    if platform not in PLATFORMS:
        raise ValueError(f"platform={platform!r}: expected one of "
                         f"{PLATFORMS}")
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return
    require_gpu()


def require_gpu() -> None:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGPUError(f"no GPU: JAX's default device is {dev} "
                         f"(platform {dev.platform!r})")


def nvidia_smi_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or None without nvidia-smi."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None


def device_stamp() -> dict:
    """platform / device_kind / count as JAX reports them, plus the
    nvidia-smi name and power limit line."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi_line()}
