"""Batched local sparse matrix products.

Re-design of ``Wrapper<K>::csrmv/csrmm`` (include/HPDDM_wrapper.hpp:
123-146 decl; :617-700 OpenMP fallback). CSR's per-row indirection is
replaced by format-specialized fixed-shape programs:

* DIA: shifts + fused multiply-add — one elementwise fusion, bound by
  memory bandwidth, zero gathers. The fast path for stencil matrices.
* ELL: one take_along_axis gather + reduction over the fixed row width.
* Dense: a batched matmul (einsum), used when the local block is
  effectively dense or tiny.

All operate on a batch x: (S, n_max, mu) — HPDDM's multi-RHS ``mu`` fused in
every kernel (pseudo-block storage) comes for free here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpddm_tpu.core.formats import BatchedDIA, BatchedELL, BatchedDense


def _hot_values(A: BatchedDIA) -> jax.Array:
    """Value planes for the SpMM hot path: the bf16 mirror when enabled
    (-hpddm_gmv_dtype; halves the dominant HBM stream), else full values."""
    return A.values_lp if A.values_lp is not None else A.values


def spmm_dia(A: BatchedDIA, x: jax.Array) -> jax.Array:
    """y[s, i, :] = sum_k vals[s, k, i] * x[s, i + off_k, :]."""
    vals = _hot_values(A)
    S, nd, n = vals.shape
    mu = x.shape[-1]
    max_off = max((abs(o) for o in A.offsets), default=0)
    if max_off == 0:
        return vals[:, 0, :, None] * x if nd else jnp.zeros_like(x)
    xp = jnp.pad(x, ((0, 0), (max_off, max_off), (0, 0)))
    out = jnp.zeros((S, n, mu), dtype=jnp.result_type(vals.dtype, x.dtype))
    for k, off in enumerate(A.offsets):
        shifted = xp[:, max_off + off: max_off + off + n, :]
        out = out + vals[:, k, :, None] * shifted
    return out


def dia_canvas_moves(offsets, Wd: int):
    """Decompose flat DIA offsets into 2-D canvas moves (di, dj) with
    |di|, |dj| <= 1, or None if any offset is not stencil-like."""
    moves = []
    for o in offsets:
        di = int(round(o / Wd)) if Wd else 0
        dj = int(o) - di * Wd
        if abs(dj) > 1 or abs(di) > 1:
            return None
        moves.append((di, dj))
    return moves


def spmm_dia_canvas(A: BatchedDIA, x: jax.Array) -> jax.Array:
    """Canvas SpMM for grid stencils (A.canvas_hw set): values viewed as
    (S, k, H, W); the +-W diagonals become free row offsets, only the
    +-1 column shifts remain. Requires seam-safe values — the E/W couplings must vanish on the canvas row
    seams, validated once at attach time (Schwarz.set_grid_geometry):
    the flat form reads across the seam, the canvas form reads padding."""
    H, Wd = A.canvas_hw
    vals = _hot_values(A)
    S, k, n = vals.shape
    mu = x.shape[-1]
    moves = dia_canvas_moves(A.offsets, Wd)
    if moves is None:
        # canvas_hw set by hand on a non-stencil offset pattern
        # (Schwarz._try_canvas_annotate never does this): fall back
        return spmm_dia(A, x)
    odt = jnp.result_type(vals.dtype, x.dtype)
    sym = A.canvas_sym if A.canvas_sym is not None else (None,) * k
    if A.values_planes is not None:
        # pre-split (S, H, W) planes: no in-jit slicing of the packed
        # buffer (it can materialize per-plane copies every scan step
        # when the state is a jit argument)
        plane = lambda ki: A.values_planes[ki]          # noqa: E731
    else:
        vc = vals.reshape(S, k, H, Wd)
        plane = lambda ki: vc[:, ki]                    # noqa: E731
    if mu == 1:
        xc = x[:, :, 0].reshape(S, H, Wd)
        xp = jnp.pad(xc, ((0, 0), (1, 1), (1, 1)))
        out = jnp.zeros((S, H, Wd), dtype=odt)
        for ki, (di, dj) in enumerate(moves):
            if sym[ki] is not None:
                # V_k[p] = V_j[p + m] (exact transpose plane): the term is
                # the m-shift of (V_j * x) — no HBM read of plane k
                base = jnp.pad(plane(sym[ki]) * xc,
                               ((0, 0), (1, 1), (1, 1)))
                out = out + base[:, 1 + di: 1 + di + H,
                                 1 + dj: 1 + dj + Wd]
            else:
                out = out + plane(ki) * \
                    xp[:, 1 + di: 1 + di + H, 1 + dj: 1 + dj + Wd]
        return out.reshape(S, n, 1)
    # mu > 1: batch the RHS axis ahead of the canvas dims so W stays the
    # minor (contiguous) dimension
    out = spmm_dia_canvas_muT(A, jnp.moveaxis(x, -1, 1))
    return jnp.moveaxis(out, 1, -1)


def spmm_dia_canvas_muT(A: BatchedDIA, xT: jax.Array) -> jax.Array:
    """Canvas SpMM with the RHS axis *leading*: (S, mu, n) -> (S, mu, n).

    The production multi-RHS layout: callers that keep vectors mu-leading
    (precond/schwarz.gmv's fused block path) avoid the transpose
    round-trips entirely — the (.., W*mu) merged-minor form relayouts the
    canvas on every op."""
    H, Wd = A.canvas_hw
    vals = _hot_values(A)
    S, k, n = vals.shape
    mu = xT.shape[1]
    moves = dia_canvas_moves(A.offsets, Wd)
    odt = jnp.result_type(vals.dtype, xT.dtype)
    sym = A.canvas_sym if A.canvas_sym is not None else (None,) * k
    if A.values_planes is not None:
        plane = lambda ki: A.values_planes[ki]          # noqa: E731
    else:
        vc = vals.reshape(S, k, H, Wd)
        plane = lambda ki: vc[:, ki]                    # noqa: E731
    xc = xT.reshape(S, mu, H, Wd)
    xp = jnp.pad(xc, ((0, 0), (0, 0), (1, 1), (1, 1)))
    out = jnp.zeros((S, mu, H, Wd), dtype=odt)
    for ki, (di, dj) in enumerate(moves):
        if sym[ki] is not None:
            base = jnp.pad(plane(sym[ki])[:, None] * xc,
                           ((0, 0), (0, 0), (1, 1), (1, 1)))
            out = out + base[:, :, 1 + di: 1 + di + H,
                             1 + dj: 1 + dj + Wd]
        else:
            out = out + plane(ki)[:, None] * \
                xp[:, :, 1 + di: 1 + di + H, 1 + dj: 1 + dj + Wd]
    return out.reshape(S, mu, n)


def spmm_dia_canvas_muT_scan(A: BatchedDIA, xT: jax.Array,
                             pair: int = 2,
                             scale=None) -> jax.Array:
    """muT canvas SpMM as a ``lax.scan`` over RHS groups.

    The fused (S, mu, ...) formulation can re-read the accumulator canvas
    once per diagonal at mu >= 3, and a python-loop chunking is
    interleaved back into that schedule by XLA.  A scan body is
    *sequential by semantics*, so each group of ``pair`` RHS runs the
    mu<=2 pass; the diagonal values are re-read once per group.  ``scale``: optional (S, n) POU to fuse into the body (the
    GMV's D-scaling — saves one full pass over y)."""
    from jax import lax

    S, mu, n = xT.shape
    if mu <= pair or mu % pair:
        y = spmm_dia_canvas_muT(A, xT)
        return y if scale is None else y * scale[:, None, :]
    # in-place carry update: the scan donates the carry buffer, so each
    # step writes only its pair-slice (no stacking/transpose copies)
    G = mu // pair

    def body(y, g):
        xm = lax.dynamic_slice_in_dim(xT, g * pair, pair, axis=1)
        ym = spmm_dia_canvas_muT(A, xm)
        if scale is not None:
            ym = ym * scale[:, None, :]
        return lax.dynamic_update_slice_in_dim(y, ym, g * pair, axis=1), None

    y0 = jnp.zeros_like(xT)
    y, _ = lax.scan(body, y0, jnp.arange(G))
    return y


def spmm_ell(A: BatchedELL, x: jax.Array) -> jax.Array:
    """y[s, i, :] = sum_w vals[s, i, w] * x[s, cols[s, i, w], :]."""
    # gathered: (S, n, w, mu)
    gathered = jnp.take_along_axis(x[:, :, None, :],
                                   A.cols[:, :, :, None], axis=1)
    return jnp.einsum("snw,snwm->snm", A.values, gathered)


def spmm_dense(A: BatchedDense, x: jax.Array) -> jax.Array:
    return jnp.einsum("snk,skm->snm", A.values, x,
                      preferred_element_type=x.dtype)


def spmm(A, x: jax.Array) -> jax.Array:
    """Dispatch on format. x: (S, n_max, mu) -> (S, n_max, mu)."""
    if isinstance(A, BatchedDIA):
        if A.canvas_hw is not None:
            return spmm_dia_canvas(A, x)
        return spmm_dia(A, x)
    if isinstance(A, BatchedELL):
        return spmm_ell(A, x)
    if isinstance(A, BatchedDense):
        return spmm_dense(A, x)
    raise TypeError(f"unsupported matrix type {type(A)}")
