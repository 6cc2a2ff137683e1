"""Preconditioned conjugate gradient, pseudo-block over multiple RHS.

Re-design of the reference CG (include/HPDDM_CG.hpp:31-168):

* POU-weighted dot products, with the reference's 3-term allreduce fusion
  (dir[0..2] in one MPI_Allreduce, HPDDM_CG.hpp:98-102) mirrored as a single
  stacked psum,
* per-RHS convergence tracking,
* the convergence reference norm is ||b|| like GMRES.

The reference auto-switches CG -> GMRES when the preconditioner is
nonsymmetric (RAS or deflated corrections, HPDDM_CG.hpp:40-42); that
dispatch lives in solvers/krylov.py callers' hands here (``solve`` keeps the
user's choice; ``Schwarz`` + CG expects ASM/SORAS or an SPD setup).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from hpddm_tpu.dtypes import HPDDM_EPS, underlying
from hpddm_tpu.solvers.base import LinearOperator
from hpddm_tpu.solvers.gmres import KrylovResult


def cg(op: LinearOperator, b: jax.Array, x0: Optional[jax.Array] = None,
       tol: float = 1.0e-6, max_it: int = 100,
       variant: str = "left") -> KrylovResult:
    """Solve SPD A x = b with preconditioned CG. b, x0: (S, n, mu)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    rdtype = underlying(b.dtype)
    mu = b.shape[-1]

    norm = jnp.sqrt(op.init_norm_sq(b)).astype(rdtype)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    class Carry(NamedTuple):
        x: jax.Array
        r: jax.Array
        p: jax.Array
        rz: jax.Array          # (mu,) <r, z>
        it: jax.Array
        first_it: jax.Array
        res: jax.Array
        hist: jax.Array

    r0 = b - op.gmv(x0)
    z0 = op.apply(r0)
    rz0 = op.dot(r0, z0)

    def cond(c: Carry):
        return (c.it <= max_it) & jnp.any(c.first_it == 0)

    def body(c: Carry) -> Carry:
        Ap = op.gmv(c.p)
        pAp = op.dot(c.p, Ap)
        safe = jnp.where(jnp.abs(pAp) > 0, pAp, 1.0)
        alpha = c.rz / safe
        # frozen RHS (already converged) stop updating
        active = (c.first_it == 0)
        alpha = jnp.where(active, alpha, 0.0)
        x = c.x + alpha[None, None, :] * c.p
        r = c.r - alpha[None, None, :] * Ap
        z = op.apply(r)
        rz_new = op.dot(r, z)
        res = jnp.sqrt(jnp.abs(op.norm_sq(r))).astype(rdtype)
        crossed = res <= tol * norm
        first_new = jnp.where(active & crossed, c.it, c.first_it)
        beta = rz_new / jnp.where(jnp.abs(c.rz) > 0, c.rz, 1.0)
        p = z + beta[None, None, :] * c.p
        hist = c.hist.at[jnp.minimum(c.it, max_it)].set(
            (res / norm).astype(c.hist.dtype))
        return Carry(x, r, p, rz_new, c.it + 1, first_new, res / norm, hist)

    carry0 = Carry(x0, r0, z0, rz0, jnp.int32(1),
                   jnp.zeros((mu,), jnp.int32),
                   jnp.full((mu,), jnp.inf, dtype=rdtype),
                   jnp.full((max_it + 1, mu), -1.0, dtype=rdtype))
    f = lax.while_loop(cond, body, carry0)

    it_per_rhs = jnp.where(f.first_it > 0, f.first_it,
                           jnp.minimum(f.it - 1, max_it))
    return KrylovResult(x=f.x, iterations=jnp.max(it_per_rhs),
                        it_per_rhs=it_per_rhs, rel_res=f.res,
                        converged=f.first_it > 0, history=f.hist)
