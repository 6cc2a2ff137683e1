"""The device the program runs on, and the dtype it computes in there.

This is the one module that asks JAX which backend is live; drivers,
examples and set-up paths that pick a dtype or a form ask here instead of
testing ``jax.default_backend()`` themselves.

* CPU (the test suite, with x64 enabled): f64 / c128, so iteration counts
  compare one to one with the reference's f64 oracles.
* GPU: f32 / c64 — the configuration the solver's device paths were
  tuned for. Set-up factorizations that need more precision are computed
  in host f64 and rounded (precond/geneo.py, ops/banded_solve.py).
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["platform", "working_dtype", "require_gpu"]


def platform() -> str:
    """The live JAX backend: ``"cpu"`` or ``"gpu"``."""
    return jax.default_backend()


def working_dtype(complex_: bool = False) -> type:
    """Scalar type of device vectors and operators on this backend."""
    if platform() == "cpu":
        return np.complex128 if complex_ else np.float64
    return np.complex64 if complex_ else np.float32


def require_gpu() -> jax.Device:
    """The first GPU device; raises when JAX found none (a measurement
    taken on the CPU is not a device measurement)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})")
    return dev
