"""Schur-complement solves for saddle-point systems.

Counterpart of the reference's PCHPDDM saddle-point support
(interface/petsc/pc/pchpddm.cxx:21, ``-pc_hpddm_schur_precondition``,
PCHPDDMSchurPreTypes least-squares/geneo): the velocity block A of

    [[A, B^T], [B, 0]] [u; p] = [f; g]

is solved by the domain-decomposition machinery (two-level GenEO-RAS by
default — any configured Schwarz applies), and the pressure Schur
complement S = B A^-1 B^T is driven by an outer CG preconditioned with
the inverse pressure mass matrix (for Stokes, S is spectrally
equivalent to Mp — Verfuerth; on a MAC grid Mp = h^2 I), with the
constant-pressure nullspace projected out (enclosed flows).

Flow (``SaddleSolver.solve``):
  1. rhs = B A^-1 f - g                     (one inner DD solve)
  2. CG on S p = rhs with prec Mp^-1, each S apply = one inner DD solve
  3. u = A^-1 (f - B^T p)                   (one inner DD solve)

The inner solves run through ``solvers.krylov.solve`` on the
decomposed velocity block at a tolerance well below the outer one, so
the outer CG sees a consistent operator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from hpddm_tpu.options import Options


class SaddleResult(NamedTuple):
    u: np.ndarray            # (n_vel,) velocity, global numbering
    p: np.ndarray            # (n_p,) pressure (zero-mean)
    outer_iterations: int
    inner_iterations: int    # accumulated across all A^-1 applies
    rel_res: float           # outer Schur-residual reduction


class SaddleSolver:
    """Host-orchestrated Schur-complement CG around jitted DD solves."""

    def __init__(self, gen, B, options: Optional[Options] = None,
                 mp_inv_scale: Optional[float] = None,
                 neumann=None):
        """gen: FromFileGenerated decomposition of A (models/stokes2d or
        any fromfile decomposition); B: (n_p, n_vel) scipy matrix;
        mp_inv_scale: pressure mass-matrix inverse scale (default 1/h^2
        is the caller's job — pass None for automatic Jacobi-of-S);
        neumann: optional GenEO auxiliary matrices for the inner solves.
        """
        import jax
        from hpddm_tpu.precond.schwarz import Schwarz
        self.opt = options if options is not None else Options()
        self.gen = gen
        self.B = B.tocsr()
        self.S = len(gen.mats)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=self.opt)
        if neumann is not None and \
                self.opt.val("schwarz_coarse_correction") is not None:
            sch.solve_gevp(neumann)
        self.sch = sch
        self.state = sch.build()
        self._inner_its = 0
        # global <-> decomposed maps (owned-dof gather)
        self.n_vel = self.B.shape[1]
        self._own = [np.asarray(gen.owner[gen.gids[s]] == s)
                     for s in range(self.S)]
        if mp_inv_scale is None:
            # Jacobi of S as fallback preconditioner scale
            mp_inv_scale = 1.0
        self.mp_inv_scale = float(mp_inv_scale)

        from hpddm_tpu.solvers.krylov import solve as _solve
        self._solve_jit = jax.jit(
            lambda st, b: _solve(st, b, opt=self.opt))

    # -- helpers ---------------------------------------------------------
    def _to_local(self, x_global: np.ndarray) -> jnp.ndarray:
        S = self.S
        out = np.zeros((S, self.sch.n_max, 1), dtype=x_global.dtype)
        for s in range(S):
            out[s, : self.gen.n_loc[s], 0] = x_global[self.gen.gids[s]]
        return jnp.asarray(out)

    def _to_global(self, x_loc) -> np.ndarray:
        x_np = np.asarray(x_loc)
        out = np.zeros(self.n_vel, dtype=x_np.dtype)
        for s in range(self.S):
            vals = x_np[s, : self.gen.n_loc[s], 0]
            out[self.gen.gids[s][self._own[s]]] = vals[self._own[s]]
        return out

    def a_solve(self, b_global: np.ndarray) -> np.ndarray:
        """x = A^-1 b through the DD solve (global numbering)."""
        res = self._solve_jit(self.state, self._to_local(b_global))
        self._inner_its += int(res.iterations)
        return self._to_global(res.x)

    # -- the Schur-complement solve --------------------------------------
    def solve(self, f: np.ndarray, g: np.ndarray, tol: float = 1.0e-8,
              max_it: int = 200) -> SaddleResult:
        B = self.B
        n_p = B.shape[0]
        self._inner_its = 0

        def proj(q):                       # remove the constant nullspace
            return q - q.mean()

        def s_apply(p):
            return proj(B @ self.a_solve(B.T @ p))

        rhs = proj(B @ self.a_solve(f) - g)
        p = np.zeros(n_p)
        r = rhs.copy()
        z = self.mp_inv_scale * r
        d = z.copy()
        rz = float(r @ z)
        nrm0 = np.linalg.norm(rhs)
        nrm0 = nrm0 if nrm0 > 0 else 1.0
        it = 0
        rel = 1.0
        while it < max_it:
            q = s_apply(d)
            alpha = rz / float(d @ q)
            p += alpha * d
            r -= alpha * q
            rel = np.linalg.norm(r) / nrm0
            it += 1
            if rel <= tol:
                break
            z = self.mp_inv_scale * r
            rz_new = float(r @ z)
            d = z + (rz_new / rz) * d
            rz = rz_new
        p = proj(p)
        u = self.a_solve(f - B.T @ p)
        return SaddleResult(u=u, p=p, outer_iterations=it,
                            inner_iterations=self._inner_its,
                            rel_res=float(rel))
