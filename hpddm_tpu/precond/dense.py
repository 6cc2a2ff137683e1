"""Dense Schwarz variant with user-supplied global operator.

Re-design of ``Dense<S, K> : Schwarz`` (include/HPDDM_dense.hpp:40-214),
the variant used for boundary-element / H-matrix integrations (htool): the
local matrices are dense, the global matrix-vector product is supplied by
the user (pure virtual ``GMV``, HPDDM_dense.hpp:199), the local
eigenproblem is a *standard* EVP (``solveEVP`` via geev,
HPDDM_dense.hpp:74-159), and the coarse operator is assembled through the
generic user GMV (``UserCoarseOperator``, HPDDM_operator.hpp:351-377).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from hpddm_tpu.core.csr import MatrixCSR
from hpddm_tpu.core.formats import BatchedDense
from hpddm_tpu.ops.local_solve import factorize
from hpddm_tpu.options import Options
from hpddm_tpu.parallel.decomposition import Decomposition
from hpddm_tpu.parallel.ops import exchange, psum_if, scaled_exchange
from hpddm_tpu.precond.schwarz import CoarseState, SchwarzState
from hpddm_tpu.solvers.base import LinearOperator


class DenseSchwarz:
    """Schwarz over dense local blocks + user global operator."""

    def __init__(self, local_blocks: Sequence[np.ndarray],
                 neighbors: Sequence[Sequence[int]],
                 mappings: Sequence[Sequence[np.ndarray]],
                 d: Optional[Sequence[np.ndarray]] = None,
                 options: Optional[Options] = None,
                 user_gmv: Optional[Callable] = None):
        """user_gmv(x: (S, n_max, mu)) -> (S, n_max, mu): the global
        operator on consistent vectors. If None, the assembled dense local
        blocks + scaled exchange provide it (like Schwarz.gmv)."""
        self.opt = options if options is not None else Options()
        n_loc = [b.shape[0] for b in local_blocks]
        # dense variant keeps the caller's numbering (user GMV closures
        # would otherwise need to permute)
        self.dec = Decomposition.from_subdomains(neighbors, mappings, n_loc,
                                                 d=d, renumber=False)
        self.n_max = self.dec.n_max
        S = len(local_blocks)
        dtype = np.result_type(*[b.dtype for b in local_blocks])
        dense = np.zeros((S, self.n_max, self.n_max), dtype=dtype)
        for s, b in enumerate(local_blocks):
            dense[s, : b.shape[0], : b.shape[1]] = b
            pad = np.arange(b.shape[0], self.n_max)
            dense[s, pad, pad] = 1.0
        self.A = BatchedDense(values=jnp.asarray(dense), n_max=self.n_max)
        self.blocks = local_blocks
        self.user_gmv = user_gmv
        self._deflation: Optional[List[np.ndarray]] = None

    def gmv(self, x: jax.Array,
            axis_name: Optional[str] = None) -> jax.Array:
        if self.user_gmv is not None:
            return self.user_gmv(x)
        y = jnp.einsum("snk,skm->snm", self.A.values, x)
        return scaled_exchange(self.dec, y, axis_name)

    def solve_evp(self, nu: Optional[int] = None) -> int:
        """Standard local EVP: dominant eigenvectors of each dense block
        (Dense::solveEVP — geev/hseqr-hsein in the reference; numpy eig
        here, setup-time host work)."""
        if nu is None:
            nu = int(self.opt.val("geneo_nu"))
        vecs = []
        for b in self.blocks:
            w, v = np.linalg.eig(np.asarray(b, dtype=np.complex128)
                                 if np.iscomplexobj(b)
                                 else np.asarray(b, dtype=np.float64))
            order = np.argsort(-np.abs(w))[:nu]
            V = v[:, order]
            if not np.iscomplexobj(b):
                V = np.real(V)
            q, _ = np.linalg.qr(V)
            vecs.append(np.ascontiguousarray(q))
        self._deflation = vecs
        return nu

    def set_vectors(self, vectors: Sequence[np.ndarray]) -> None:
        self._deflation = [np.atleast_2d(np.asarray(v)).reshape(
            self.blocks[s].shape[0], -1) for s, v in enumerate(vectors)]

    def build(self) -> LinearOperator:
        """Factorize and return a LinearOperator (gmv + M^-1)."""
        solver = factorize(self.A.values, kind=self.opt.val("local_solver"))
        dec = self.dec
        variant = self.opt.val("schwarz_method")
        coarse = None
        correction = self.opt.val("schwarz_coarse_correction")
        if correction is not None and self._deflation is not None:
            coarse = self._build_coarse(correction)

        state = SchwarzState(dec=dec, A=self.A, solver=solver,
                             coarse=coarse, variant=variant)
        self._state = state

        from hpddm_tpu.precond import schwarz as sz

        def apply(x, axis_name=None):
            if coarse is None:
                return sz.one_level_apply(state, x, axis_name)
            # two-level corrections but with the (possibly user) gmv
            out = sz.deflation(state, x, axis_name)
            work = x - self.gmv(out, axis_name)
            work = solver.solve(work)
            work = scaled_exchange(dec, work, axis_name)
            if correction == "balanced":
                work = work - sz.deflation(state, self.gmv(work, axis_name),
                                           axis_name)
            return out + work

        return LinearOperator(gmv=lambda x: self.gmv(x),
                              apply=lambda x: apply(x),
                              weight=dec.d)

    def _build_coarse(self, correction: str) -> CoarseState:
        """E = Z^T A Z through the (user) GMV (UserCoarseOperator)."""
        dec = self.dec
        S = dec.S
        vecs = self._deflation
        nu_loc = np.array([v.shape[1] for v in vecs], dtype=np.int32)
        nu_max = int(nu_loc.max(initial=1))
        dtype = self.A.values.dtype
        Z = np.zeros((S, self.n_max, nu_max), dtype=np.asarray(
            vecs[0]).dtype)
        for s, v in enumerate(vecs):
            Z[s, : v.shape[0], : v.shape[1]] = v
        Z = jnp.asarray(Z, dtype=dtype)
        DZ = dec.d[:, :, None] * Z
        N_c = S * nu_max
        X0 = jnp.zeros((S, self.n_max, N_c), dtype=dtype)
        cols = (jnp.arange(S)[:, None] * nu_max + jnp.arange(nu_max)[None, :])
        s_idx = jnp.broadcast_to(jnp.arange(S)[:, None, None],
                                 (S, self.n_max, nu_max))
        r_idx = jnp.broadcast_to(jnp.arange(self.n_max)[None, :, None],
                                 (S, self.n_max, nu_max))
        c_idx = jnp.broadcast_to(cols[:, None, :], (S, self.n_max, nu_max))
        X0 = X0.at[s_idx, r_idx, c_idx].set(DZ)
        X = exchange(dec, X0)
        Y = self.gmv(X)
        E = jnp.einsum("snp,sn,snq->pq", jnp.conj(X), dec.d, Y)
        slot_active = (jnp.arange(nu_max)[None, :]
                       < jnp.asarray(nu_loc)[:, None]).reshape(-1)
        E = jnp.where(slot_active[:, None] & slot_active[None, :], E,
                      jnp.eye(N_c, dtype=E.dtype))
        E_inv = jnp.asarray(np.linalg.inv(np.asarray(E, dtype=np.complex128
                                                     if jnp.iscomplexobj(E)
                                                     else np.float64)),
                            dtype=E.dtype)
        return CoarseState(Z=Z, E_inv=E_inv, E=None,
                           nu_loc=jnp.asarray(nu_loc), nu_max=nu_max,
                           correction=correction)