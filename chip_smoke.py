"""One-card smoke run: the SIFT -> match -> RANSAC path on the GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths
                                       # and their one-card twins only

Phases (sift_tpu/smoke.py holds each as a function): device check;
pipeline.detect_object at 1920x1080 on a seeded planar scene;
parity of the card against the CPU backend (960x960 demo size) and
against the NumPy oracle; geometry/BA precision. Every phase raises
on failure; the process then exits non-zero and prints no result line. Numbers go on
earlier lines, each with the card's name and power limit; the last
line is one JSON object naming the device.

The run needs a GPU: without one it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the parity phases compare the card with the CPU backend of this same
# process, so the CPU platform must stay enabled beside the GPU
_plats = os.environ.get("JAX_PLATFORMS")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"


def _run(phase: str, card: str, fn, *args) -> None:
    """Run one phase (it raises on failure) and print its numbers with
    the card and the phase's wall seconds, compilation included."""
    from sift_tpu.smoke import log
    log(f"{phase}: start")
    t0 = time.perf_counter()
    result = fn(*args)
    result["phase_seconds"] = time.perf_counter() - t0
    print(f"[{phase}] card={card} "
          + json.dumps(result, sort_keys=True, default=float), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and their "
                         "one-card comparisons")
    args = ap.parse_args(argv)

    from sift_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from sift_tpu import smoke
    from sift_tpu.utils.device import require_gpu, nvidia_smi_line

    require_gpu()
    card = nvidia_smi_line() or "unknown"
    print(card, flush=True)
    t_all = time.perf_counter()
    _run("device", card, smoke.phase_device, "gpu")
    if args.four_cards:
        _run("four_cards", card, smoke.phase_four_cards, 4)
    else:
        _run("pipeline", card, smoke.phase_pipeline)
        _run("parity", card, smoke.phase_parity)
        _run("precision", card, smoke.phase_precision)
    print(f"[total] card={card} seconds={time.perf_counter() - t_all:.1f}",
          flush=True)
    import jax
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
