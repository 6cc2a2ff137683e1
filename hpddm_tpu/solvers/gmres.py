"""Restarted GMRES, pseudo-block over multiple right-hand sides.

Re-design of the reference GMRES (include/HPDDM_GMRES.hpp:30-158):

* left / right / flexible preconditioning (``-hpddm_variant``),
* CGS (one fused Gram matmul + one psum) or MGS orthogonalization,
* Givens-updated residual norms — no extra collective per convergence
  check (HPDDM_iterative.hpp:669-710),
* per-RHS convergence tracking (``hasConverged``): the reported iteration
  count is the first iteration at which each RHS crossed the tolerance.

Everything is shape-static for XLA: the Krylov basis is a fixed
(restart+1, S, n, mu) buffer, inner/outer loops are ``lax.while_loop``,
and column counts are carried as traced integers with masking. CGS
orthogonalizes against the full (restart+1)-row basis with a mask — on the
device one large masked matmul beats a dynamic-length loop.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from hpddm_tpu.dtypes import HPDDM_EPS, machine_eps, underlying
from hpddm_tpu.solvers.base import LinearOperator


class KrylovResult(NamedTuple):
    x: jax.Array           # (S, n, mu) solution
    iterations: jax.Array  # () int32 — global iteration count (max over RHS)
    it_per_rhs: jax.Array  # (mu,) int32 — first crossing per RHS
    rel_res: jax.Array     # (mu,) — final Givens residual estimate / norm(b)
    converged: jax.Array   # (mu,) bool
    # (max_it + 1, mu) per-iteration relative residual estimates, -1 where
    # not reached — the KSPMonitor / verbosity>2 printout analogue
    history: jax.Array = None


def _givens(a, b):
    """Givens rotation (c, s, r): with G = [[conj(c), conj(s)], [-s, c]],
    G [a; b] = [r; 0] and r = sqrt(|a|^2 + |b|^2) real. Valid for complex
    scalars (conj applications live at the call sites)."""
    denom = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(b) ** 2)
    safe = jnp.where(denom > 0, denom, 1.0)
    c = jnp.where(denom > 0, a / safe, 1.0)
    s = jnp.where(denom > 0, b / safe, 0.0)
    return c, s, denom


def _tri_solve_masked(H, s, count):
    """Solve the (count x count) upper-triangular LS system per RHS.

    H: (m, m+1, mu) — H[k] is Arnoldi column k (already Givens-rotated, so
    rows 0..m-1 form R); s: (m+1, mu) rotated residual coefficients;
    count: (mu,) int32 — columns in use per RHS. Returns y (m, mu) with
    y[j] = 0 for j >= count.
    """
    m = H.shape[0]
    mu = s.shape[-1]
    dtype = H.dtype

    def body(step, y):
        j = m - 1 - step
        # sum_{k>j} R[j,k] y[k] ; R[j,k] = H[k, j]
        row = H[:, j, :]                       # (m, mu): R[j, k] over k
        acc = jnp.sum(jnp.where(jnp.arange(m)[:, None] > j, row * y, 0), axis=0)
        diag = H[j, j, :]
        safe = jnp.where(jnp.abs(diag) > 0, diag, 1.0)
        yj = (s[j] - acc) / safe
        yj = jnp.where(j < count, yj, 0.0)
        return y.at[j].set(yj.astype(dtype))

    y0 = jnp.zeros((m, mu), dtype=dtype)
    return lax.fori_loop(0, m, body, y0)


def gmres(op: LinearOperator, b: jax.Array, x0: Optional[jax.Array] = None,
          tol: float = 1.0e-6, restart: int = 40, max_it: int = 100,
          variant: str = "right", ortho: str = "cgs") -> KrylovResult:
    """Solve A x = b with (preconditioned) restarted GMRES.

    b, x0: (S, n, mu). `variant` in {"left", "right", "flexible"}; `ortho`
    in {"cgs", "mgs"}.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    S, n, mu = b.shape
    m = int(restart)
    dtype = b.dtype
    rdtype = underlying(dtype)
    flexible = variant == "flexible"
    left = variant == "left"

    # Reference initializeNorm: the convergence reference norm is ||b|| for
    # right/flexible, ||M^-1 b|| for left (HPDDM_iterative.hpp:922-onwards).
    nb = op.apply(b) if left else b
    norm = jnp.sqrt(op.init_norm_sq(nb)).astype(rdtype)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    class Carry(NamedTuple):
        x: jax.Array
        it: jax.Array             # global iteration counter (starts at 1)
        first_it: jax.Array       # (mu,) first tol crossing (0 = not yet)
        res: jax.Array            # (mu,) current residual estimates
        stop: jax.Array           # () bool — converged or breakdown
        hist: jax.Array           # (max_it + 1, mu) residual history

    def cycle(carry: Carry) -> Carry:
        x = carry.x
        r = b - op.gmv(x)
        if left:
            r = op.apply(r)
        beta_sq = op.norm_sq(r)
        beta = jnp.sqrt(beta_sq).astype(rdtype)
        breakdown = jnp.all(beta_sq < machine_eps(dtype) ** 2)
        safe_beta = jnp.where(beta > 0, beta, 1.0)

        V = jnp.zeros((m + 1, S, n, mu), dtype=dtype)
        V = V.at[0].set(r / safe_beta)
        Z = jnp.zeros((m, S, n, mu), dtype=dtype) if flexible else None
        H = jnp.zeros((m, m + 1, mu), dtype=dtype)
        # accumulated rotation product Q (m+1, m+1, mu): applying all
        # previous Givens rotations to a new column is ONE small matvec
        # instead of an i-step sequential loop (same arithmetic, ~40x
        # fewer kernels in the hot loop)
        Q = jnp.broadcast_to(jnp.eye(m + 1, dtype=dtype)[:, :, None],
                             (m + 1, m + 1, mu)).copy()
        svec = jnp.zeros((m + 1, mu), dtype=dtype).at[0].set(beta.astype(dtype))

        class Inner(NamedTuple):
            V: jax.Array
            Z: Optional[jax.Array]
            H: jax.Array
            Q: jax.Array
            svec: jax.Array
            i: jax.Array
            it: jax.Array
            first_it: jax.Array
            res: jax.Array
            all_conv: jax.Array
            hist: jax.Array

        def inner_cond(st: Inner):
            return (st.i < m) & (st.it <= max_it) & ~st.all_conv

        def inner_body(st: Inner) -> Inner:
            vi = st.V[st.i]
            if left:
                w = op.apply(op.gmv(vi))
                Z_new = st.Z
            else:
                z = op.apply(vi)
                w = op.gmv(z)
                Z_new = st.Z.at[st.i].set(z) if flexible else st.Z

            # --- orthogonalization -----------------------------------
            mask = (jnp.arange(m + 1) <= st.i)[:, None]
            if ortho in ("cgs", "cgs2"):
                h = op.gram(st.V, w)                        # (m+1, mu)
                h = jnp.where(mask, h, 0)
                w = w - jnp.einsum("km,ksnm->snm", h, st.V)
                if ortho == "cgs2":
                    # iterated CGS: one extra fused Gram pass + psum
                    # restores orthogonality over long f32 bases ("twice is
                    # enough"); the coefficients fold into the same h
                    h2 = op.gram(st.V, w)
                    h2 = jnp.where(mask, h2, 0)
                    w = w - jnp.einsum("km,ksnm->snm", h2, st.V)
                    h = h + h2
            else:  # mgs
                def mgs_step(j, acc):
                    w_, h_ = acc
                    hj = op.dot(st.V[j], w_)
                    hj = jnp.where(j <= st.i, hj, 0)
                    w_ = w_ - hj[None, None, :] * st.V[j]
                    return (w_, h_.at[j].set(hj.astype(dtype)))
                w, h = lax.fori_loop(0, m + 1, mgs_step,
                                     (w, jnp.zeros((m + 1, mu), dtype=dtype)))
            hn_sq = op.norm_sq(w)
            hn = jnp.sqrt(hn_sq).astype(dtype)
            safe_hn = jnp.where(jnp.abs(hn) > 0, hn, 1.0)
            V_new = st.V.at[st.i + 1].set(w / safe_hn)
            h = h.at[st.i + 1].set(hn)

            # --- apply all previous rotations in one matvec -----------
            h = jnp.einsum("ijm,jm->im", st.Q, h)

            hi = h[st.i]
            hi1 = h[st.i + 1]
            c, s_, rr = _givens(hi, hi1)
            h = h.at[st.i].set(rr.astype(dtype)).at[st.i + 1].set(0)
            # fold the new rotation into the product: rows i, i+1 of Q
            qi = st.Q[st.i]
            qi1 = st.Q[st.i + 1]
            Q_new = st.Q.at[st.i].set(jnp.conj(c) * qi + jnp.conj(s_) * qi1) \
                        .at[st.i + 1].set(-s_ * qi + c * qi1)
            si = st.svec[st.i]
            svec_new = st.svec.at[st.i + 1].set((-s_ * si).astype(dtype)) \
                               .at[st.i].set((jnp.conj(c) * si).astype(dtype))
            H_new = st.H.at[st.i].set(h)

            res = jnp.abs(svec_new[st.i + 1])
            crossed = res <= tol * norm
            first_new = jnp.where((st.first_it == 0) & crossed, st.it,
                                  st.first_it)
            all_conv = jnp.all(crossed)
            hist = st.hist.at[jnp.minimum(st.it, max_it)].set(
                (res / norm).astype(st.hist.dtype))
            return Inner(V_new, Z_new, H_new, Q_new, svec_new,
                         st.i + 1, st.it + 1, first_new, res, all_conv,
                         hist)

        st0 = Inner(V, Z, H, Q, svec, jnp.int32(0), carry.it,
                    carry.first_it, carry.res, jnp.array(False),
                    carry.hist)
        stf = lax.while_loop(inner_cond, inner_body, st0)

        # --- solution update (updateSol: HPDDM_iterative.hpp:272-336) ----
        count = jnp.where(stf.first_it > 0,
                          jnp.minimum(stf.i, stf.first_it - carry.it + 1),
                          stf.i)
        y = _tri_solve_masked(stf.H, stf.svec, count)
        col_mask = (jnp.arange(m)[:, None] < count)
        y_masked = jnp.where(col_mask, y, 0)
        if flexible:
            upd = jnp.einsum("km,ksnm->snm", y_masked, stf.Z)
        else:
            u = jnp.einsum("km,ksnm->snm", y_masked, stf.V[:m])
            upd = op.apply(u) if not left else u
        x_new = x + upd

        stop = stf.all_conv | (stf.it > max_it) | breakdown
        return Carry(x_new, stf.it, stf.first_it, stf.res, stop, stf.hist)

    hist0 = jnp.full((max_it + 1, mu), -1.0, dtype=rdtype)
    carry0 = Carry(x0, jnp.int32(1), jnp.zeros((mu,), jnp.int32),
                   jnp.full((mu,), jnp.inf, dtype=rdtype), jnp.array(False),
                   hist0)
    final = lax.while_loop(lambda c: ~c.stop, cycle, carry0)

    it_per_rhs = jnp.where(final.first_it > 0, final.first_it,
                           jnp.minimum(final.it - 1, max_it))
    iterations = jnp.max(it_per_rhs)
    return KrylovResult(x=final.x, iterations=iterations,
                        it_per_rhs=it_per_rhs,
                        rel_res=final.res / norm,
                        converged=final.first_it > 0,
                        history=final.hist)
