"""Completion barriers for device timing.

On the GPU ``jax.block_until_ready`` waits for the device: on one H100
(700 W limit) a 200-step GMV chain at 2048^2/16 took 15.19-15.38 ms to
``block_until_ready`` and 15.36-15.63 ms to a scalar :func:`fetch`, and a
fetch issued after ``block_until_ready`` returned in about 1 ms (a slice
dispatch plus a device-to-host copy, not more waiting;
tools/bench_xla_paths.py, PERF.md). Either barrier ends a timing bracket;
:func:`fetch` costs about 1 ms more per call.

:func:`timed` brackets with :func:`fetch`, which also serves as the start
barrier of the next bracket: all prior dispatched work on the stream is
complete once a later result's value has been read.
"""

from __future__ import annotations

import time

import jax
import numpy as np

__all__ = ["fetch", "timed"]


def fetch(x):
    """Completion barrier: read one scalar from the first array leaf of
    ``x`` back to the host.  Returns that scalar (numpy) or None when
    ``x`` holds no non-empty array leaf."""
    for leaf in jax.tree_util.tree_leaves(x):
        size = getattr(leaf, "size", 0)
        if size and hasattr(leaf, "ravel"):
            return np.asarray(jax.device_get(leaf.ravel()[0]))
    return None


def timed(fn, *args, reps=3, warmup=1):
    """Best-of-``reps`` fetch-synced wall time of ``fn(*args)``.

    Returns ``(best_seconds, worst_seconds, last_result)``.  The bracket
    both starts and ends synchronized: each rep's trailing :func:`fetch`
    doubles as the next rep's start barrier."""
    y = None
    for _ in range(max(warmup, 1)):
        y = fn(*args)
        fetch(y)
    best, worst = float("inf"), 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        y = fn(*args)
        fetch(y)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        worst = max(worst, dt)
    return best, worst, y
