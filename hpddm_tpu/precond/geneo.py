"""GenEO spectral coarse spaces.

Re-design of the reference GenEO pipeline:

* ``scale_into_overlap`` — B = D A D restricted to the geometric overlap
  (``Schwarz::scaleIntoOverlap``, HPDDM_schwarz.hpp:622-657),
* ``solve_gevp`` — the local generalized eigenproblem
  A_neu v = lambda B v, smallest lambdas. The reference reverse-communicates
  with ARPACK in shift-invert mode (sigma=0, bmat="G", which="LM" on
  A^-1 B — HPDDM_ARPACK.hpp:84-151). Here we go *batched dense*: subdomain
  problems are small and eigh is a matmul-shaped one-shot:
      A_reg = A_neu + eps*scale*I  (the null-pivot regularization MUMPS
      ICNTL(24) provides in the reference)
      L = chol(A_reg);  C = L^-1 B L^-T;  eigh(C) -> mu descending
      lambda = 1/mu, v = L^-T y  (largest mu == smallest pencil lambda)
  vmapped over the subdomain axis — every device factors its own
  subdomains.
* ``select_nu`` — threshold cut + ``geneo_force_uniformity`` min/max
  (``Eigensolver::selectNu``, HPDDM_eigensolver.hpp:106-159). The
  deflation operator Z E^-1 Z^T is invariant under per-subdomain invertible
  column transforms of Z, so eigenvector scaling is free.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hpddm_tpu.core.formats import batched_dense_from
from hpddm_tpu.parallel.decomposition import Decomposition


def scale_into_overlap(A, dec: Decomposition) -> jax.Array:
    """B = (D A D) restricted to overlap rows/cols, dense (S, n, n)."""
    Ad = batched_dense_from(A)
    mask = dec.ov_mask.astype(Ad.dtype)
    dd = dec.d * mask                                        # zero off-overlap
    return Ad * dd[:, :, None] * dd[:, None, :]


def solve_gevp_dense(A_neu: jax.Array, B: jax.Array, nu_max: int,
                     reg: float = 1.0e-10) -> Tuple[jax.Array, jax.Array]:
    """Batched pencil solve: nu_max smallest-lambda eigenpairs of
    A_neu v = lambda B v with B PSD (possibly singular).

    Both inputs are symmetrized first: the reference's test generator
    assembles *nonsymmetric* local matrices when the overlap clamps the
    subdomain width (the ``Nx // xGrid`` vertical-offset quirk,
    examples/generate.cpp:201), which the reference tolerates by running
    nonsymmetric ARPACK (dnaupd). The GenEO coarse space only needs a good
    spectral subspace, and XLA has no nonsymmetric eig on accelerators, so
    we solve
    the symmetric part's pencil:

        A^{-1/2} = U diag(1/sqrt(max(w, eps))) U^T   (eigh-based, no chol)
        C = A^{-1/2} B A^{-1/2};  eigh(C) -> mu descending; lambda = 1/mu

    Returns (eigenvalues (S, nu_max) ascending, vectors (S, n, nu_max)).
    """
    S, n, _ = A_neu.shape
    if A_neu.dtype in (jnp.float32.dtype, jnp.bfloat16.dtype):
        # sub-f64 on-device GEVP loses the small pencil eigenvalues that
        # GenEO needs; compute the setup-time eigensolve in host f64
        lam, V = _solve_gevp_dense_np(np.asarray(A_neu, dtype=np.float64),
                                      np.asarray(B, dtype=np.float64),
                                      nu_max, reg)
        return (jnp.asarray(lam, dtype=A_neu.dtype),
                jnp.asarray(V, dtype=A_neu.dtype))
    A_sym = 0.5 * (A_neu + jnp.swapaxes(A_neu, 1, 2))
    B_sym = 0.5 * (B + jnp.swapaxes(B, 1, 2))
    scale = jnp.mean(jnp.abs(jnp.diagonal(A_sym, axis1=1, axis2=2)), axis=1)

    def one(As, Bs, sc):
        w, U = jnp.linalg.eigh(As)
        floor = jnp.maximum(reg * sc, 10 * jnp.finfo(w.dtype).tiny)
        w_safe = jnp.maximum(w, floor)
        inv_sqrt = U * (1.0 / jnp.sqrt(w_safe))[None, :]
        C = inv_sqrt.T @ Bs @ inv_sqrt
        C = 0.5 * (C + C.T)
        mu, Y = jnp.linalg.eigh(C)                            # ascending
        mu_top = mu[::-1][:nu_max]                            # largest mu
        Y_top = Y[:, ::-1][:, :nu_max]
        V = inv_sqrt @ Y_top
        nrm = jnp.linalg.norm(V, axis=0, keepdims=True)
        V = V / jnp.where(nrm > 0, nrm, 1.0)
        lam = jnp.where(mu_top > 1e3 * jnp.finfo(mu.dtype).eps,
                        1.0 / mu_top, jnp.inf)
        return lam, V

    lam, V = jax.vmap(one)(A_sym, B_sym, scale)
    return lam, V


def _solve_gevp_dense_np(A_neu: np.ndarray, B: np.ndarray, nu_max: int,
                         reg: float):
    """Host-f64 twin of solve_gevp_dense (numpy, looped over subdomains)."""
    S, n, _ = A_neu.shape
    lam_out = np.empty((S, nu_max))
    V_out = np.empty((S, n, nu_max))
    for s in range(S):
        As = 0.5 * (A_neu[s] + A_neu[s].T)
        Bs = 0.5 * (B[s] + B[s].T)
        scale = np.mean(np.abs(np.diag(As)))
        w, U = np.linalg.eigh(As)
        floor = max(reg * scale, 10 * np.finfo(w.dtype).tiny)
        w_safe = np.maximum(w, floor)
        inv_sqrt = U * (1.0 / np.sqrt(w_safe))[None, :]
        C = inv_sqrt.T @ Bs @ inv_sqrt
        C = 0.5 * (C + C.T)
        mu, Y = np.linalg.eigh(C)
        mu_top = mu[::-1][:nu_max]
        Y_top = Y[:, ::-1][:, :nu_max]
        V = inv_sqrt @ Y_top
        nrm = np.linalg.norm(V, axis=0, keepdims=True)
        V = V / np.where(nrm > 0, nrm, 1.0)
        lam_out[s] = np.where(mu_top > 1e3 * np.finfo(mu.dtype).eps,
                              1.0 / mu_top, np.inf)
        V_out[s] = V
    return lam_out, V_out


def solve_gevp_lanczos(apply_Ainv, apply_B, S: int, n: int, nu_max: int,
                       ncv: int = None, seed: int = 0,
                       dtype=jnp.float64, aux=None):
    """Shift-invert Lanczos for the pencil A v = lambda B v at sigma = 0 —
    the matrix-free analogue of the reference's ARPACK mode-3 loop
    (HPDDM_ARPACK.hpp:84-151), batched over subdomains, for local sizes
    where the dense pencil (solve_gevp_dense) is out of reach.

    apply_Ainv(x): (S, n, 1) -> A^-1 x  (exact or inner-Krylov; the
        reference applies the factorized Neumann matrix here)
    apply_B(x):    (S, n, 1) -> B x     (the overlap-masked D A D)

    B-orthonormal Lanczos with full reorthogonalization on the operator
    A^-1 B; the largest Ritz values theta give the smallest pencil
    eigenvalues lambda = 1/theta. Returns (lam (S, nu_max), V (S, n,
    nu_max)).

    The whole iteration is one ``lax.scan`` over the fixed-size basis
    arrays: the body traces a single (apply_Ainv, 2x apply_B, two Gram
    matmuls) step, so the compile cost is independent of ncv (an unrolled
    formulation compiles for minutes at 1M dofs). Reorthogonalization coefficients reuse the stored B.v columns
    ((B u)^T w == u^T B w up to the symmetric part), turning the O(ncv^2)
    apply_B calls of the naive loop into one (S, n, ncv) matmul per step.
    """
    if ncv is None:
        ncv = max(2 * nu_max + 1, 12)
    ncv = min(ncv, n)
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.normal(size=(S, n, 1)), dtype=dtype)

    # the operators' state must cross the jit boundary as *arguments*: a
    # closure-captured state (e.g. a banded factor, ~1 GB at 1M dofs)
    # would be embedded into the HLO as a literal and inflate compile time
    # and program size (note jax.closure_convert does NOT hoist concrete
    # arrays — only closed-over tracers — so callers with big states must
    # pass ``aux`` and signatures apply(aux, x))
    if aux is not None:
        fA, fB = apply_Ainv, apply_B
    else:
        fA = lambda _unused, x: apply_Ainv(x)      # noqa: E731
        fB = lambda _unused, x: apply_B(x)         # noqa: E731

    @jax.jit
    def run(v, aux):
        # purge the raw random start into range(A^-1 B) first: the operators
        # mask/project padded rows and kernel directions, so one application
        # removes the O(1) noise the raw vector carries on invalid slots —
        # otherwise full reorthogonalization propagates it into every basis
        # column and the returned eigenvectors are polluted on padded rows
        v = fA(aux, fB(aux, v))
        nrm = jnp.sqrt(jnp.abs(jnp.einsum("snm,snm->s", v, fB(aux, v))))
        v = v / jnp.maximum(nrm, 1e-30)[:, None, None]

        def step(carry, j):
            v, V, BV, OpV = carry
            Bv = fB(aux, v)
            w = fA(aux, Bv)                                # Op v_j
            V = jax.lax.dynamic_update_index_in_dim(V, v[:, :, 0], j, axis=2)
            BV = jax.lax.dynamic_update_index_in_dim(BV, Bv[:, :, 0], j,
                                                     axis=2)
            OpV = jax.lax.dynamic_update_index_in_dim(OpV, w[:, :, 0], j,
                                                      axis=2)
            # full B-reorthogonalization (twice) against columns 0..j —
            # the not-yet-filled columns are zero, contributing nothing
            for _ in range(2):
                c = jnp.einsum("snj,sn->sj", BV, w[:, :, 0])
                w = w - jnp.einsum("snj,sj->sn", V, c)[:, :, None]
            beta = jnp.sqrt(jnp.abs(jnp.einsum("snm,snm->s", w,
                                               fB(aux, w))))
            v = w / jnp.maximum(beta, 1e-30)[:, None, None]
            return (v, V, BV, OpV), None

        Z = jnp.zeros((S, n, ncv), dtype=dtype)
        (_, V, BV, OpV), _ = jax.lax.scan(step, (v, Z, Z, Z),
                                          jnp.arange(ncv))
        return V, BV, OpV

    V, BV, OpV = run(v, aux)

    # small projected problem per subdomain: T = V^T_B (A^-1 B) V_B is
    # symmetric in the B-inner product; build it densely from the basis
    # (full reorthogonalization makes the tridiagonal assumption fragile)
    T = jnp.einsum("snj,snk->sjk", BV, OpV)                      # V^T B Op V
    T = 0.5 * (T + jnp.swapaxes(T, 1, 2))
    T_np = np.asarray(T)
    lam_out = np.full((S, nu_max), np.inf)
    Y_out = np.zeros((S, ncv, nu_max))
    for s in range(S):
        w_s, y_s = np.linalg.eigh(T_np[s])
        order = np.argsort(-w_s)[:nu_max]
        theta = w_s[order]
        good = theta > 1e-12
        lam_out[s, : len(order)] = np.where(good, 1.0 / np.where(
            good, theta, 1.0), np.inf)
        Y_out[s, :, : len(order)] = y_s[:, order]
    Vec = jnp.einsum("snj,sjk->snk", V, jnp.asarray(Y_out, dtype=dtype))
    nrm = jnp.linalg.norm(Vec, axis=1, keepdims=True)
    Vec = Vec / jnp.where(nrm > 0, nrm, 1.0)
    return jnp.asarray(lam_out, dtype=dtype), Vec


def select_nu(eigenvalues: np.ndarray, nu_req: np.ndarray,
              threshold: Optional[float] = None,
              force_uniformity: Optional[str] = None,
              rng: Optional[np.random.Generator] = None,
              vectors: Optional[np.ndarray] = None):
    """Per-subdomain count selection (Eigensolver::selectNu).

    eigenvalues: (S, nu_max) ascending pencil eigenvalues;
    nu_req: (S,) requested counts (geneo_nu, possibly nonuniform).
    Returns (nu_loc (S,), vectors possibly padded for force max).
    """
    S, nu_max = eigenvalues.shape
    nu_loc = np.minimum(np.asarray(nu_req, dtype=np.int64), nu_max)
    if threshold is not None and threshold > 0:
        below = (eigenvalues < threshold).sum(axis=1)
        # the reference's upper_bound starts at +1: keep at least one vector
        nu_loc = np.minimum(nu_loc, np.maximum(below, 1))
    if force_uniformity == "min":
        nu_loc[:] = nu_loc.min()
    elif force_uniformity == "max":
        target = int(nu_loc.max())
        if vectors is not None and rng is not None:
            # pad deficient subdomains with random vectors orthonormalized
            # against the computed ones (HPDDM_eigensolver.hpp:124-148)
            for s in range(S):
                for k in range(int(nu_loc[s]), target):
                    v = rng.uniform(0.0, 1.0, size=vectors.shape[1])
                    basis = vectors[s, :, :k]
                    v = v - basis @ (basis.T @ v)
                    nrm = np.linalg.norm(v)
                    vectors[s, :, k] = v / (nrm if nrm > 0 else 1.0)
        nu_loc[:] = target
    return nu_loc, vectors
