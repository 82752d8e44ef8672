"""Stage timing + profiler hooks (aux subsystem, SURVEY.md §5).

The reference's only observability is wall-clock printfs around its
three stages (src/sift.cpp:63-88) and per-blur-call timing
(src/sift.cpp:126-151). This module is the structured replacement:
named stage timers that wait for the device work they time
(`jax.block_until_ready`; JAX returns before the device finishes, so
a timer without it measures the enqueue), plus a hook into
jax.profiler for full XLA traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax
import numpy as np


class StageTimer:
    """Accumulating named stage timer.

    with timer.stage("pyramid"):       # times the enclosed block
        out = build(...)
        timer.sink(out)                # ensures device work completed
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, List[float]] = {}
        self._sink = None

    def sink(self, tree) -> None:
        self._sink = tree

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        self._sink = None
        t0 = time.perf_counter()
        yield self
        if self._sink is not None:
            jax.block_until_ready(self._sink)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        """Median seconds per stage."""
        return {k: float(np.median(v)) for k, v in self.times.items()}

    def report(self) -> str:
        lines = [f"{k:>24s}: {v * 1e3:9.3f} ms"
                 for k, v in self.summary().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str]):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
