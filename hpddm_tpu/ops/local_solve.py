"""Batched local direct solves.

Replaces the reference's SUBDOMAIN plug-ins (MUMPS / MKL PARDISO /
SuiteSparse / PaStiX / Dissection — e.g. ``MumpsSub::numfact/solve``,
include/HPDDM_MUMPS.hpp:229-313): there is no external sparse direct solver
on the device, and subdomain problems are small (1e3-1e5 dofs), so local
solves are *batched dense* factorizations, vmapped over the subdomain axis.

Strategies (option ``-hpddm_local_solver``):

* ``inv``  — explicit inverse computed once at setup; ``solve`` is a single
  batched matmul. A matmul runs at full device rate while triangular
  solves serialize, so this is the fast path for the Krylov hot loop. Iteration
  counts match ``lu`` to roundoff.
* ``lu``   — LU with partial pivoting (jax.scipy lu_factor/lu_solve).
* ``chol`` — Cholesky for SPD local matrices.
* ``qr``   — Householder QR; also provides the pseudo-inverse path that
  HPDDM gates behind ``HPDDM_QR`` for singular Neumann matrices (FETI/BDD).

Padded rows must be identity rows (pack_local_matrices guarantees this) so
the padded system stays non-singular and pads solve to x_pad = b_pad.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalSolver:
    kind: str = dataclasses.field(metadata=dict(static=True))
    # inv: factor = A^-1 ; lu: factor = packed LU, aux = pivots ;
    # chol: factor = L ; qr: factor = Q, aux = R
    factor: jax.Array = None
    aux: Optional[jax.Array] = None

    def solve(self, b: jax.Array) -> jax.Array:
        """Solve A x = b for a batch b: (S, n, mu) (multi-RHS fused)."""
        if self.kind == "inv":
            return jnp.einsum("snk,skm->snm", self.factor, b,
                              preferred_element_type=b.dtype)
        if self.kind == "lu":
            return jax.vmap(lambda lu, piv, rhs: jsl.lu_solve((lu, piv), rhs))(
                self.factor, self.aux, b)
        if self.kind == "chol":
            def one(L, rhs):
                y = jsl.solve_triangular(L, rhs, lower=True)
                return jsl.solve_triangular(L.T.conj(), y, lower=False)
            return jax.vmap(one)(self.factor, b)
        if self.kind == "qr":
            def one(q, r, rhs):
                return jsl.solve_triangular(r, q.T.conj() @ rhs, lower=False)
            return jax.vmap(one)(self.factor, self.aux, b)
        raise ValueError(f"unknown local solver kind {self.kind!r}")


def factorize(A: jax.Array, kind: str = "inv") -> LocalSolver:
    """Factorize a batch of dense local matrices A: (S, n, n).

    For sub-f64 dtypes the explicit inverse is computed in f64 on the host
    and rounded once: inverting an ill-conditioned local matrix *in* f32
    loses ~cond(A) accuracy and measurably degrades the preconditioner
    (the reference's direct solvers always factorize in full precision)."""
    if kind == "inv":
        if A.dtype in (jnp.float32.dtype, jnp.bfloat16.dtype):
            import numpy as np
            inv = np.linalg.inv(np.asarray(A, dtype=np.float64))
            return LocalSolver(kind="inv",
                               factor=jnp.asarray(inv, dtype=A.dtype))
        return LocalSolver(kind="inv", factor=jnp.linalg.inv(A))
    if kind == "lu":
        lu, piv = jax.vmap(jsl.lu_factor)(A)
        return LocalSolver(kind="lu", factor=lu, aux=piv)
    if kind == "chol":
        return LocalSolver(kind="chol", factor=jnp.linalg.cholesky(A))
    if kind == "qr":
        q, r = jnp.linalg.qr(A)
        return LocalSolver(kind="qr", factor=q, aux=r)
    raise ValueError(f"unknown local solver kind {kind!r}")


def factorize_pinv(A: jax.Array, rtol: float = 1e-10) -> LocalSolver:
    """Pseudo-inverse factorization for (possibly singular) Neumann matrices
    (FETI's K^+ — HPDDM regularizes or QR-pseudo-inverts, HPDDM_schur.hpp:
    338-353). Batched eigh-based: A^+ = V diag(1/λ where λ>tol) V^T."""
    w, v = jnp.linalg.eigh(A)
    tol = rtol * jnp.max(jnp.abs(w), axis=-1, keepdims=True)
    inv_w = jnp.where(jnp.abs(w) > tol, 1.0 / w, 0.0)
    pinv = jnp.einsum("snk,sk,smk->snm", v, inv_w, v)
    return LocalSolver(kind="inv", factor=pinv)
