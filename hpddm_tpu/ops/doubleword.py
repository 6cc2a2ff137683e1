"""Double-word (paired-f32) arithmetic for on-device iterative refinement.

With an f32 device solve, ``solvers/refine.py`` gets f64-grade residuals
by round-tripping to the host every pass. This module removes the
round-trip: the solution is carried as an unevaluated pair ``x = hi + lo``
of f32 arrays (~48 mantissa bits) and the residual ``r = b - A x`` is
computed entirely on device with error-free transformations (Knuth 2Sum,
Dekker split/2Prod — classical double-word a.k.a. "double-double"
arithmetic, Joldes/Muller/Popescu 2017). All operations are elementwise
— no matrix products, so the f32 arithmetic is IEEE round-to-nearest and
the transforms are exact as long as the compiler does not contract them
into fused multiply-adds.

Analogue in the reference: HPDDM's mixed precision only goes *down*
(coarse level in ``downscaled_type<K>``, HPDDM_coarse_operator.hpp:73);
an f32 device solve needs the opposite direction, residuals *above*
working precision.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Pair = Tuple[jax.Array, jax.Array]


def _split_factor(dtype) -> float:
    # Dekker split: 2^ceil(p/2) + 1 with p = mantissa bits + 1
    if jnp.dtype(dtype) == jnp.float32:
        return 4097.0          # 2^12 + 1
    return 134217729.0         # 2^27 + 1 (f64)


def two_sum(a: jax.Array, b: jax.Array) -> Pair:
    """Error-free sum: a + b = s + e exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: jax.Array, b: jax.Array) -> Pair:
    """Error-free sum assuming |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a: jax.Array, b: jax.Array) -> Pair:
    """Error-free product: a * b = p + e exactly (Dekker split form —
    every partial product is exactly representable, so XLA fusing any of
    the multiply-adds into FMAs cannot change the values)."""
    p = a * b
    f = jnp.asarray(_split_factor(a.dtype), dtype=a.dtype)
    ca = f * a
    ah = ca - (ca - a)
    al = a - ah
    cb = f * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dw_renorm(h: jax.Array, l: jax.Array) -> Pair:
    """Renormalize so |lo| <= ulp(hi)/2."""
    return fast_two_sum(h, l)


def dw_add(x: Pair, y: Pair) -> Pair:
    """Double-word + double-word (sloppy variant: O(eps^2) relative
    error — ample for residual accumulation)."""
    sh, se = two_sum(x[0], y[0])
    se = se + (x[1] + y[1])
    return fast_two_sum(sh, se)


def dw_neg(x: Pair) -> Pair:
    return -x[0], -x[1]


def dw_mul_f32(a: jax.Array, x: Pair) -> Pair:
    """f32 * double-word."""
    p, pe = two_prod(a, x[0])
    pe = pe + a * x[1]
    return fast_two_sum(p, pe)


def dw_from(a: jax.Array) -> Pair:
    return a, jnp.zeros_like(a)


def dw_to(x: Pair, dtype=None) -> jax.Array:
    s = x[0] + x[1]
    return s.astype(dtype) if dtype is not None else s


def spmm_dia_dw(A, x: Pair) -> Pair:
    """Double-word batched DIA SpMM: y = A x with x, y double-word and the
    matrix values f32. Same shifted-slice structure as ``spmv.spmm_dia``;
    each diagonal contributes an error-free product folded into a
    double-word accumulator.
    """
    S, nd, n = A.values.shape
    xh, xl = x
    mu = xh.shape[-1]
    max_off = max((abs(o) for o in A.offsets), default=0)
    zero = jnp.zeros((S, n, mu), dtype=xh.dtype)
    if max_off == 0:
        if not nd:
            return zero, zero
        return dw_mul_f32(A.values[:, 0, :, None], (xh, xl))
    pad = ((0, 0), (max_off, max_off), (0, 0))
    xph = jnp.pad(xh, pad)
    xpl = jnp.pad(xl, pad)
    acc = (zero, zero)
    for k, off in enumerate(A.offsets):
        sl = slice(max_off + off, max_off + off + n)
        vk = A.values[:, k, :, None]
        term = dw_mul_f32(vk, (xph[:, sl, :], xpl[:, sl, :]))
        acc = dw_add(acc, term)
    return acc


def spmm_ell_dw(A, x: Pair) -> Pair:
    """Double-word batched ELL SpMM: per-slot gathers + double-word
    accumulation over the fixed row width (no einsum — the reduction must
    stay elementwise for the error-free transforms)."""
    xh, xl = x
    gh = jnp.take_along_axis(xh[:, :, None, :], A.cols[:, :, :, None],
                             axis=1)
    gl = jnp.take_along_axis(xl[:, :, None, :], A.cols[:, :, :, None],
                             axis=1)
    w = A.values.shape[-1]
    S, n = A.values.shape[0], A.values.shape[1]
    mu = xh.shape[-1]
    zero = jnp.zeros((S, n, mu), dtype=xh.dtype)
    acc = (zero, zero)
    for j in range(w):
        vk = A.values[:, :, j, None]
        term = dw_mul_f32(vk, (gh[:, :, j, :], gl[:, :, j, :]))
        acc = dw_add(acc, term)
    return acc


def spmm_dw(A, x: Pair) -> Pair:
    """Dispatch on format (DIA/ELL; dense local blocks have no error-free
    matrix product — callers fall back to host refinement there)."""
    from hpddm_tpu.core.formats import BatchedDIA, BatchedELL
    if isinstance(A, BatchedDIA):
        return spmm_dia_dw(A, x)
    if isinstance(A, BatchedELL):
        return spmm_ell_dw(A, x)
    raise TypeError(
        f"double-word SpMM needs DIA or ELL local matrices, got {type(A)}")
