"""Wall-clock timing of jitted calls.

``time_call`` warms ``f`` up (the first call compiles), then times each call
to the end of the device work with ``jax.block_until_ready`` and returns the
median.  The reference times its GPU path the same way, with CUDA events
around the filter call (experiments/mvm_err.py:20-41).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax

__all__ = ["time_call"]


def time_call(f: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median wall-clock seconds of ``f(*args)`` after ``warmup`` calls."""
    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
