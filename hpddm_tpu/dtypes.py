"""Scalar type system.

Replaces HPDDM's template scalar machinery (HPDDM.hpp:290-327:
``underlying_type<K>``, ``downscaled_type<K>``, ``upscaled_type<K>``) with
jnp dtype helpers. Complex support mirrors K in {float, double,
complex<float>, complex<double>}; mixed precision maps the coarse level to
the next-lower precision (f64 -> f32 -> bf16) like HPDDM_MIXED_PRECISION.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_COMPLEX = {jnp.complex64.dtype, jnp.complex128.dtype}


def underlying(dtype) -> jnp.dtype:
    """Real type underlying a (possibly complex) scalar type."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.complex64.dtype:
        return jnp.float32.dtype
    if dtype == jnp.complex128.dtype:
        return jnp.float64.dtype
    return dtype


def is_complex(dtype) -> bool:
    return jnp.dtype(dtype) in _COMPLEX


def downscaled(dtype) -> jnp.dtype:
    """Next-lower precision (coarse-level storage under mixed precision).

    f64 -> f32, f32 -> bf16, c128 -> c64, c64 -> c64 (there is no complex bf16).
    """
    dtype = jnp.dtype(dtype)
    table = {
        jnp.float64.dtype: jnp.float32.dtype,
        jnp.float32.dtype: jnp.bfloat16.dtype,
        jnp.complex128.dtype: jnp.complex64.dtype,
        jnp.complex64.dtype: jnp.complex64.dtype,
        jnp.bfloat16.dtype: jnp.bfloat16.dtype,
    }
    return table.get(dtype, dtype)


def upscaled(dtype) -> jnp.dtype:
    """Next-higher precision (residual replay / reproducibility checks)."""
    dtype = jnp.dtype(dtype)
    table = {
        jnp.bfloat16.dtype: jnp.float32.dtype,
        jnp.float32.dtype: jnp.float64.dtype,
        jnp.float64.dtype: jnp.float64.dtype,
        jnp.complex64.dtype: jnp.complex128.dtype,
        jnp.complex128.dtype: jnp.complex128.dtype,
    }
    return table.get(dtype, dtype)


def conj(x):
    """Conjugate for complex dtypes, identity otherwise (Wrapper<K>::conj)."""
    return jnp.conj(x) if is_complex(x.dtype) else x


def machine_eps(dtype) -> float:
    return float(np.finfo(np.dtype(underlying(dtype))).eps)


# Dirichlet-penalty constants (HPDDM_define.hpp:47-48).
HPDDM_EPS = 1.0e-12
HPDDM_PEN = 1.0e+30
