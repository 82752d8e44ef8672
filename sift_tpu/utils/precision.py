"""Full float32 matrix products for the geometry and SfM stack.

On a GPU, XLA may run a float32 product with default precision in
TF32 (about three decimal digits). Minimal solvers, RANSAC refinement
and bundle adjustment need every bit: their answers are null spaces
and small residual differences. `highest_precision` traces the
function it wraps with every product at full float32 precision; it
sits innermost (under jax.jit), so it holds whatever the caller's
context.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
