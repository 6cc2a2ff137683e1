"""Chebyshev inexact local solves for large subdomains.

The reference's SUBDOMAIN solvers are exact sparse direct factorizations
(MUMPS & co. — e.g. MumpsSub::numfact/solve, include/HPDDM_MUMPS.hpp:
229-313). Batched dense factors cap local sizes at ~10k dofs
(O(n^2) memory) and the DST fast solver (ops/fft_solve.py) is exact only
for the constant-coefficient stencil. For *large heterogeneous* grid
subdomains the native answer is an inexact local solve:

    k steps of preconditioned Chebyshev iteration on the local matrix,
    preconditioned by the DST solve (spectrally equivalent for variable-
    coefficient diffusion: cond(M^-1 A) ~ coefficient contrast, independent
    of n) or by the Jacobi diagonal.

Chebyshev with *fixed* coefficients is a fixed linear operator, so the
resulting RAS/ORAS preconditioner stays linear — plain (non-flexible)
GMRES remains valid, unlike inner-Krylov local solves. Zero factorization
memory; every step is one SpMV + one DST solve.

Per-subdomain spectral bounds of M^-1 A are estimated at setup by batched
power iteration (lmax) and shifted power iteration (lmin), with safety
margins (overestimating lmax is safe, overestimating lmin is not).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from hpddm_tpu.ops.spmv import spmm


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JacobiSolver:
    """Diagonal solve — the minimal inner preconditioner."""
    dinv: jax.Array                 # (S, n_max)

    def solve(self, b: jax.Array) -> jax.Array:
        return self.dinv[:, :, None] * b


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChebyLocalSolver:
    """k-step preconditioned Chebyshev as a batched local solver."""
    A: Any                          # Batched{DIA,ELL,Dense} local matrices
    inner: Optional[Any]            # DST solver (fft_solve) or None
    dinv: Optional[jax.Array]       # (S, n_max) Jacobi fallback when inner=None
    # symmetric diagonal scaling R = sqrt(diag(L)/diag(A)) making the DST
    # preconditioner M = R^-1 L R^-1 match A's diagonal — for
    # heterogeneous kappa this clusters spec(M^-1 A) by the *local* jump
    # structure instead of the global contrast
    scale: Optional[jax.Array]      # (S, n_max) or None
    lo: jax.Array                   # (S,) lower spectral bound of M^-1 A
    hi: jax.Array                   # (S,) upper spectral bound
    k: int = dataclasses.field(metadata=dict(static=True))

    def _minv(self, r: jax.Array) -> jax.Array:
        if self.inner is not None:
            if self.scale is not None:
                s = self.scale[:, :, None]
                return s * self.inner.solve(s * r)
            return self.inner.solve(r)
        return self.dinv[:, :, None] * r

    def solve(self, b: jax.Array) -> jax.Array:
        """Approximate A^-1 b by k Chebyshev steps; b: (S, n_max, mu)."""
        theta = ((self.hi + self.lo) / 2.0)[:, None, None]
        delta = ((self.hi - self.lo) / 2.0)[:, None, None]
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        x = jnp.zeros_like(b)
        r = b
        d = self._minv(r) / theta
        for _ in range(self.k):
            x = x + d
            r = r - spmm(self.A, d)
            z = self._minv(r)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * z
            rho = rho_new
        return x + d


def _extract_dinv(A, n_max: int) -> jax.Array:
    from hpddm_tpu.core.formats import BatchedDIA, BatchedELL, BatchedDense
    if isinstance(A, BatchedDIA):
        k0 = A.offsets.index(0)
        diag = A.values[:, k0, :]
    elif isinstance(A, BatchedELL):
        row = jnp.arange(n_max, dtype=A.cols.dtype)[None, :, None]
        hit = (A.cols == row)
        diag = jnp.sum(jnp.where(hit, A.values, 0), axis=2)
    elif isinstance(A, BatchedDense):
        diag = jnp.diagonal(A.values, axis1=1, axis2=2)
    else:
        raise TypeError(type(A))
    return jnp.where(jnp.abs(diag) > 0, 1.0 / diag, 1.0)


def build_cheby_solver(A, row_mask: jax.Array, inner: Optional[Any] = None,
                       k: int = 16, power_its: int = 30,
                       seed: int = 7) -> ChebyLocalSolver:
    """Estimate per-subdomain bounds of M^-1 A and build the solver.

    row_mask: (S, n_max) bool — valid rows (pads are excluded from the
    spectral estimates; the DST preconditioner returns zero there and the
    POU is zero there, so pad values never propagate).
    """
    S, n_max = row_mask.shape
    dtype = A.values.dtype
    dinv = None if inner is not None else _extract_dinv(A, n_max)
    scale = None
    if inner is not None:
        # R = sqrt(diag(L)/diag(A)); the Dirichlet-box DST Laplacian has a
        # constant diagonal, recoverable as 1/(L^-1-free solve of e)...
        # use the A-diagonal directly: R makes diag(M) = diag(A)
        dA = 1.0 / _extract_dinv(A, n_max)
        # representative diag(L): median of diag(A) where kappa ~ 1 is
        # unknown; use per-subdomain max of the *unit* stencil — the DST
        # solver was built for the unit-coefficient operator whose diag is
        # constant, so any constant works up to a global factor absorbed
        # by the spectral bounds. Take 1.0.
        r = jnp.sqrt(jnp.where(jnp.abs(dA) > 0, 1.0 / jnp.abs(dA), 1.0))
        scale = jnp.where(row_mask, r, 0.0).astype(dtype)
    sol = ChebyLocalSolver(A=A, inner=inner, dinv=dinv, scale=scale,
                           lo=jnp.ones(S, dtype), hi=jnp.ones(S, dtype), k=k)
    mask = row_mask[:, :, None].astype(dtype)

    def op(v):
        return sol._minv(spmm(A, v)) * mask

    def normalize(v):
        nrm = jnp.sqrt(jnp.sum(v * v, axis=(1, 2), keepdims=True))
        return v / jnp.where(nrm > 0, nrm, 1.0)

    key = jax.random.PRNGKey(seed)
    v = normalize(jax.random.normal(key, (S, n_max, 1), dtype) * mask)

    @jax.jit
    def estimate(v):
        # lmax: power iteration on M^-1 A
        def pw(v, _):
            w = op(v)
            lam = jnp.sum(v * w, axis=(1, 2))
            return normalize(w), lam
        v1, lams = jax.lax.scan(pw, v, None, length=power_its)
        lmax = lams[-1]
        # lmin: power iteration on (s I - M^-1 A), s = 1.05 lmax
        shift = 1.05 * lmax
        def pw2(v, _):
            w = shift[:, None, None] * v * mask - op(v)
            lam = jnp.sum(v * w, axis=(1, 2))
            return normalize(w), lam
        v2, lams2 = jax.lax.scan(pw2, v1, None, length=power_its)
        lmin = shift - lams2[-1]
        return lmax, lmin

    lmax, lmin = estimate(v)
    # safety: widen both ends (overestimating hi only slows convergence;
    # lo must stay strictly positive)
    hi = 1.05 * lmax
    lo = jnp.maximum(0.7 * lmin, 1e-4 * lmax)
    return dataclasses.replace(sol, lo=lo.astype(dtype), hi=hi.astype(dtype))
