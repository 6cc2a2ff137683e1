"""Mixed-precision iterative refinement around the device solve.

A single-precision device solve bottoms out at a true-residual floor
~ cond(A) * eps_f32. The classic fix is iterative refinement with the
residual in higher precision:

    repeat: r = b - A x          (host, f64, per-subdomain CSR SpMV)
            e = solve(r)         (device, f32, the full DD preconditioned
                                  Krylov solve — jitted once, reused)
            x = x + e            (host, f64)

Each pass multiplies the true residual by the f32-achievable reduction,
so 2-4 passes reach f64-grade residuals while every FLOP of the inner
solve stays on the device in f32. This generalizes the reference's
mixed-precision design (HPDDM downscales only the *coarse* level,
HPDDM_coarse_operator.hpp:73); here the whole device solve is the
"low" precision and the host plays the f64 role.

The per-subdomain residual is exact on every row with a complete stencil;
incomplete rows carry zero partition-of-unity weight, so they never enter
the convergence functional (see parallel/ops.weighted_norm_sq).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from hpddm_tpu.core.csr import MatrixCSR


def solve_refined_device(state, f, opt=None, tol: float = 1.0e-12,
                         max_refine: int = 6, axis_name=None,
                         verbose: bool = False):
    """All-on-device mixed-precision refinement (no host f64 round-trip).

    Same loop as :func:`solve_refined`, but the f64 role is played by
    double-word f32 arithmetic (ops/doubleword.py): the solution is the
    unevaluated pair ``x = hi + lo`` and the per-subdomain residual
    ``b - A x`` is computed with error-free transforms on the device. The
    consistency projection (POU-scale + copy-sum) is applied to the hi/lo
    components separately — safe because the projected copies are
    near-equal small residuals (no cancellation), unlike the GMV exchange
    whose partial row sums do cancel.

    state: a SchwarzState with DIA or ELL local matrices.
    f: (S, n_max, mu) RHS in the caller's numbering, consistent copies.
    opt: inner-solve options (e.g. tol=1e-3 per pass).

    Returns (x (S, n_max, mu) f64 host array in the caller numbering,
    info dict like solve_refined). Works under shard_map (pass
    axis_name) — every op is the batched/sharded-neutral kind.
    """
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.ops.doubleword import (dw_add, dw_from, dw_mul_f32,
                                          dw_neg, dw_renorm, spmm_dw)
    from hpddm_tpu.parallel.ops import exchange
    from hpddm_tpu.solvers.krylov import _solve_core

    dec = state.dec
    f = jnp.asarray(f)
    if f.ndim == 2:
        f = f[:, :, None]
    b = dec.permute(f) if dec.renumbered else f
    d = dec.d[:, :, None]
    nb = jnp.sqrt(jnp.sum(d * b * b))

    @jax.jit
    def residual(xh, xl):
        y = spmm_dw(state.A, (xh, xl))
        r = dw_add(dw_from(b), dw_neg(y))
        rh, rl = dw_mul_f32(d, r)
        rh = exchange(dec, rh, axis_name)
        rl = exchange(dec, rl, axis_name)
        rh, rl = dw_renorm(rh, rl)
        rel = jnp.sqrt(jnp.sum(d * rh * rh)) / jnp.maximum(nb, 1e-30)
        return rh, rel

    # state crosses the jit boundary as an ARGUMENT: closure-captured
    # states are embedded as HLO literals
    @jax.jit
    def correct(st, xh, xl, rh):
        res = _solve_core(st, rh, None, opt, axis_name)
        xh, xl = dw_add((xh, xl), dw_from(res.x))
        return xh, xl, res.iterations

    xh = jnp.zeros_like(b)
    xl = jnp.zeros_like(b)
    history, inner_its = [], []
    for p in range(max_refine):
        rh, rel = residual(xh, xl)
        rel = float(rel)
        history.append(rel)
        if verbose:
            print(f"refine pass {p}: dw weighted rel res = {rel:.3e}")
        if rel <= tol:
            break
        xh, xl, its = correct(state, xh, xl, rh)
        inner_its.append(int(np.max(np.asarray(its))))
    x = (np.asarray(xh, dtype=np.float64)
         + np.asarray(xl, dtype=np.float64))
    if dec.renumbered:
        # unpermute on host in f64 (the device gather would have to round
        # the pair back to f32 first)
        iperm = np.asarray(dec.iperm)
        x = np.take_along_axis(x, iperm[:, :, None], axis=1)
    return x, {"history": history, "inner_iterations": inner_its}


def _host_consistency(dec, rd: np.ndarray) -> np.ndarray:
    """f64 host replica of ``scaled_exchange`` on an already d-weighted
    residual: every duplicated dof gets the d-weighted sum of its copies
    (the consistency projector); interior dofs (d=1) pass through."""
    if_idx = np.asarray(dec.if_idx)
    if_mask = np.asarray(dec.if_mask)
    partners = np.asarray(dec.partners)
    S, m = if_idx.shape
    mu = rd.shape[-1]
    vals = np.take_along_axis(rd, if_idx[:, :, None], axis=1)
    vals = np.where(if_mask[:, :, None], vals, 0.0)
    flat = np.concatenate([vals.reshape(S * m, mu),
                           np.zeros((1, mu))], axis=0)
    summed = vals + flat[partners].sum(axis=2)
    out = rd.copy()
    s_idx = np.broadcast_to(np.arange(S)[:, None], (S, m))
    out[s_idx[if_mask], if_idx[if_mask]] = summed[if_mask]
    return out


def solve_refined(solve_fn: Callable, mats: Sequence[MatrixCSR],
                  f: np.ndarray, dec,
                  tol: float = 1.0e-10, max_refine: int = 5,
                  verbose: bool = False):
    """Iteratively refined solve of the decomposed system.

    solve_fn(b_device_dtype) -> KrylovResult — the jitted device solve
        (e.g. ``jax.jit(lambda b: solve(state, b, opt=opt))``).
    mats: host-side per-subdomain CSR matrices (original numbering).
    f: (S, n_max, mu) host RHS (consistent across duplicated dofs).
    dec: the Decomposition (for the partition of unity and the
        consistency projector). The per-subdomain host residual is junk
        on incomplete-stencil rows and carries roundoff disagreement
        between duplicated copies; both stall the decomposed inner solve
        and pollute the norm, so every pass projects the residual onto
        the consistent subspace in f64 first.

    Returns (x (S, n_max, mu) f64 host array, info dict with per-pass
    weighted true-residual norms and inner iteration counts).
    """
    S, n_max, mu = f.shape
    f64 = np.asarray(f, dtype=np.float64)
    d64 = np.asarray(dec.d, dtype=np.float64)
    x = np.zeros((S, n_max, mu), dtype=np.float64)
    A_h = [m.scipy(expand=True).tocsr().astype(np.float64) for m in mats]

    def wnorm(v):
        return np.sqrt(np.sum(d64[:, :, None] * v * v))

    nb = wnorm(f64)            # f is consistent by assumption
    # summed POU weight of every dof's copies: 1 up to the rounding of a
    # low-precision d, divided out when x is made consistent
    dsum = _host_consistency(dec, np.broadcast_to(
        d64[:, :, None], (S, n_max, 1)).copy())
    history, inner_its = [], []
    dev_dtype = np.asarray(f).dtype    # the device precision (e.g. f32)
    for p in range(max_refine):
        r = f64.copy()
        for s in range(S):
            n = A_h[s].shape[0]
            r[s, :n] -= A_h[s] @ x[s, :n]
        # consistent representation in f64 (already d-weighted + summed);
        # norm counts every dof class once (sum of d over a class is 1)
        rcons = _host_consistency(dec, d64[:, :, None] * r)
        rel = np.sqrt(np.sum(d64[:, :, None] * rcons * rcons)) \
            / max(nb, 1e-300)
        history.append(rel)
        if verbose:
            print(f"refine pass {p}: true weighted rel res = {rel:.3e}")
        if rel <= tol:
            break
        res = solve_fn(rcons.astype(dev_dtype))
        e = np.asarray(res.x, dtype=np.float64)
        inner_its.append(int(np.max(np.asarray(res.iterations))))
        # the device correction's copies of a duplicated dof agree only
        # to its working precision; averaging them keeps x one global
        # vector, so the host residual above sees what a caller assembles
        # (unaveraged, the disagreement sits in the residual's blind spot
        # and caps the global residual near cond(A) * eps_dev * |x|)
        x = np.where(dsum > 0, _host_consistency(
            dec, d64[:, :, None] * (x + e)) / np.where(dsum > 0, dsum, 1),
            x + e)
    return x, {"history": history, "inner_iterations": inner_its}
