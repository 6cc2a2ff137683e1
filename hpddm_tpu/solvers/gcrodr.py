"""GCRO-DR: GMRES with deflated restarting and subspace recycling.

Re-design of include/HPDDM_GCRODR.hpp:35-444 (single space; the block
variant reuses this machinery). Structure:

* the recycled pair (U, C = A_prec U, C orthonormal) lives in the
  *preconditioned operator* space (op = A M^-1 for the right variant,
  M^-1 A for left), exactly like the reference's updateSolRecycling
  bookkeeping (HPDDM_iterative.hpp:337-393),
* each cycle runs a projected Arnoldi on (I - C C^H) op with the fused CGS
  Gram (one psum covering both the C-projection coefficients B and the
  Hessenberg column), jitted as one XLA program per cycle,
* at the end of the first full cycle, harmonic Ritz vectors of the
  Hessenberg (H + h_{p+1,p}^2 H^-H e_p e_p^T) g = theta g seed U
  (HPDDM_GCRODR.hpp:676-707); later cycles solve the Parks et al.
  generalized problem G^H G p = theta G^H (Q^H W) p with the small dense
  cross products — the reference's "prod" allreduce
  (HPDDM_GCRODR.hpp:745-760). The small nonsymmetric eigensolves run as
  host callbacks (numpy), mirroring the reference's LAPACK geev calls —
  XLA has no nonsymmetric eig on accelerators.
* recycling across solves: pass ``recycled=result.recycled`` into the next
  call (the analogue of OptionsPrefix::storage_ / -hpddm_recycle_same_system).

Orchestration is eager per cycle (a handful of host syncs per restart, not
per iteration); the hot loop is compiled.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hpddm_tpu.dtypes import HPDDM_EPS, underlying
from hpddm_tpu.solvers.base import LinearOperator
from hpddm_tpu.solvers.gmres import KrylovResult


class RecycledSpace(NamedTuple):
    """Recycle pair persisted across solves (HPDDM_option.hpp storage_).

    U: (S, n, k) recycle basis (preconditioned-operator space); pseudo-block
       gcrodr with mu > 1 stores per-RHS slabs as (S, n, k, mu).
    C: same shape as U; C = op @ U, orthonormal in the weighted dot
       (each trailing-mu slab orthonormal independently)."""
    U: jax.Array
    C: jax.Array


class GCRODRResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array
    it_per_rhs: jax.Array
    rel_res: jax.Array
    converged: jax.Array
    recycled: Optional[RecycledSpace]


def _select_ritz(w: np.ndarray, k: int, target: str) -> np.ndarray:
    """Indices of k eigenvalues by -hpddm_recycle_target (SM default)."""
    if target == "LM":
        key = -np.abs(w)
    elif target == "SR":
        key = np.real(w)
    elif target == "LR":
        key = -np.real(w)
    elif target == "SI":
        key = np.abs(np.imag(w))
    elif target == "LI":
        key = -np.abs(np.imag(w))
    else:  # SM
        key = np.abs(w)
    return np.argsort(key)[:k]


def _harmonic_ritz_first(H_np: np.ndarray, p: int, k: int,
                         target: str) -> np.ndarray:
    """First-cycle harmonic Ritz of the (p+1) x p Hessenberg. Returns the
    real (p, k) coefficient matrix."""
    Hs = H_np[:p, :p]
    h2 = H_np[p, p - 1] ** 2
    ep = np.zeros(p)
    ep[-1] = 1.0
    try:
        corr = h2 * np.linalg.solve(Hs.conj().T, np.outer(ep, ep))
    except np.linalg.LinAlgError:
        corr = 0.0
    w, vr = np.linalg.eig(Hs + corr)
    idx = _select_ritz(w, k, target)
    P = vr[:, idx]
    P = np.real(P) if not np.iscomplexobj(H_np) else P
    # orthonormalize the coefficient block for stability
    q, _ = np.linalg.qr(P)
    return np.ascontiguousarray(q)


def _harmonic_ritz_general(G: np.ndarray, QhW: Optional[np.ndarray], k: int,
                           target: str) -> np.ndarray:
    """Parks et al. pencil: G^H G p = theta G^H (Q^H W) p.

    G: (d+1, d), QhW: (d+1, d) with d = k + p; QhW=None is the reference's
    -hpddm_recycle_strategy B (HPDDM_GCRODR.hpp:322-382): the cross
    products Q^H W are replaced by the orthogonality assumption
    [C, V]^H [U, V] = I (no global reduction), so the right-hand matrix of
    the pencil collapses to G^H truncated to its first d rows.
    Returns real (d, k)."""
    import scipy.linalg as sla
    Amat = G.conj().T @ G
    Bmat = G[:-1, :].conj().T if QhW is None else G.conj().T @ QhW
    w, vr = sla.eig(Amat, Bmat)
    finite = np.isfinite(w)
    w = np.where(finite, w, np.inf)
    # theta here approximates 1/harmonic-Ritz-value; the reference selects
    # on the pencil eigenvalues directly with the same target
    idx = _select_ritz(w, k, target)
    P = vr[:, idx]
    P = np.real(P) if not np.iscomplexobj(G) else P
    q, _ = np.linalg.qr(P)
    return np.ascontiguousarray(q)


def _rrqr_block(op: LinearOperator, r: jax.Array, dtol: float):
    """Rank-revealing QR of a residual block r (S, n, mu) via the Gram
    eigendecomposition: r = Q0 @ R0 with Q0 (S, n, bw) orthonormal and
    R0 (bw, mu), where bw counts singular values above ``dtol`` relative
    to the largest (the role of the reference's pivoted-QR deflation,
    HPDDM_iterative.hpp:583-595 / -hpddm_deflation_tol)."""
    from hpddm_tpu.solvers.block import _block_dot

    G = np.asarray(_block_dot(op, r, r))              # (mu, mu) PSD
    w, v = np.linalg.eigh(G)
    w = np.maximum(w, 0.0)
    s = np.sqrt(w)[::-1]                              # descending
    v = v[:, ::-1]
    bw = max(int(np.sum(s > dtol * max(s[0], 1e-300))), 1)
    T = v[:, :bw]
    s_k = np.maximum(s[:bw], 1e-300)
    Q0 = jnp.einsum("snm,ma->sna", r, jnp.asarray(T / s_k[None, :],
                                                  dtype=r.dtype))
    R0 = jnp.asarray(s_k[:, None] * np.conj(T).T, dtype=r.dtype)
    return Q0, R0, bw


def bgcrodr_fused(op: LinearOperator, b: jax.Array,
                  x0: Optional[jax.Array] = None, tol: float = 1.0e-6,
                  restart: int = 40, max_it: int = 100,
                  recycle: int = 0, target: str = "SM",
                  recycled: Optional[RecycledSpace] = None,
                  same_system: bool = False,
                  strategy: str = "A",
                  deflation_tol: float = -1.0) -> "GCRODRResult":
    """True block GCRO-DR (HPDDM_GCRODR.hpp:446-907): one fused block
    Krylov space over all RHS, deflated restarting via block harmonic Ritz.

    First full cycle: harmonic Ritz of the square block Hessenberg with
    the rank-mu correction Hsq^{-H} e_p (H_last^H H_last) e_p^H
    (the block form of HPDDM_GCRODR.hpp:676-707). Later cycles: the
    coupled-projection pencil over [U, V_p] — op([U, V_p]) =
    [C, V_{p+1}] G with G = [[I, B], [0, Hbar]] — solved with the same
    Parks strategy-A generalized eigenproblem as the mu=1 path
    (HPDDM_GCRODR.hpp:745-850). Right-preconditioned only (the variant
    the reference defaults to). Dispatched for krylov_method=bgcrodr
    with mu > 1; ``bgcrodr`` (sequential shared-recycle) remains the
    gcrodr-with-multiple-RHS path."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    S, n, mu = b.shape
    dtype = b.dtype
    rdtype = underlying(dtype)
    # Reference sizing (HPDDM_GCRODR.hpp:517,603,694): restart m0 and
    # recycle k are counted in BLOCK iterations — each cycle runs
    # m0 - k block Arnoldi steps (m0 on the first, recycle-less cycle)
    # and the recycle space holds deflated*k columns (bK), where
    # "deflated" is the post-RRQR block width.
    k = int(recycle)
    m0 = max(int(restart), k + 1)

    from hpddm_tpu.solvers.block import _block_dot, _chol_qr

    def prec(x):
        return op.apply(x)

    def op_apply(x):
        return op.gmv(prec(x))

    from hpddm_tpu.solvers.block import _init_norm
    norm = _init_norm(op, b, rdtype)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    x = x0
    r = b - op.gmv(x)
    U = C = None
    if k and recycled is not None and recycled.U is not None:
        U, C = recycled.U, recycled.C
        if U.ndim == 4:
            # pseudo-block gcrodr stores per-RHS (S, n, k, mu) slabs; each
            # C[..., nu] is orthonormal, so slab 0 is a valid seed here
            U, C = U[..., 0], C[..., 0]
        if not (1 <= U.shape[-1] <= k * mu):
            U = C = None
    if U is not None:
        if not same_system:
            AU = _apply_cols(op_apply, U)
            Q, Rfac = _tall_qr(op, AU)
            C, U = Q, _solve_right_tri(U, Rfac)
        cr = _cross_j(op, C, r)                       # (k, mu)
        x = x + prec(jnp.einsum("snk,km->snm", U, cr))
        r = r - jnp.einsum("snk,km->snm", C, cr)

    it = 1
    first_it = np.zeros(mu, dtype=np.int64)
    while it <= max_it:
        kc = U.shape[-1] if U is not None else 0      # current space width
        if deflation_tol > 0:
            # deflated restarting: drop residual directions below the
            # tolerance; the cycle runs at block width bw <= mu while the
            # (bw, mu) R0 keeps tracking every RHS (-hpddm_deflation_tol,
            # HPDDM_GCRODR.hpp block-size reduction)
            Q0, R0, bw = _rrqr_block(op, r, deflation_tol)
        else:
            Q0, R0 = _chol_qr(op, r)
            bw = mu
        # block steps this cycle: m0 - k with a recycle space, m0 without
        # (reference inner loop: i = (U ? k : 0); while (i < m[0]) ...)
        p = max(m0 - (k if U is not None else 0), 1)
        V = [Q0]                                      # block basis
        Z = []                                        # preconditioned blocks
        Hb = np.zeros((p + 1, p, bw, bw))             # block Hessenberg
        Bb = np.zeros((kc, p, bw)) if kc else None    # C-coupling
        steps = 0
        res = None
        for i in range(p):
            z = prec(V[i])
            Z.append(z)
            w = op.gmv(z)
            if C is not None:
                Bc = _cross_j(op, C, w)               # (k, bw)
                w = w - jnp.einsum("snk,km->snm", C, Bc)
                Bb[:, i, :] = np.asarray(Bc)
            for j, Vj in enumerate(V):
                Hij = _block_dot(op, Vj, w)
                w = w - jnp.einsum("sna,ab->snb", Vj, Hij)
                Hb[j, i] = np.asarray(Hij)
            Qn, Rn = _chol_qr(op, w)
            Hb[i + 1, i] = np.asarray(Rn)
            V.append(Qn)
            steps = i + 1
            # block LS residual per RHS
            Hmat = Hb[: i + 2, : i + 1].transpose(0, 2, 1, 3).reshape(
                (i + 2) * bw, (i + 1) * bw)
            rhs = np.zeros(((i + 2) * bw, mu))
            rhs[:bw] = np.asarray(R0)
            y, *_ = np.linalg.lstsq(Hmat, rhs, rcond=None)
            res = np.linalg.norm(rhs - Hmat @ y, axis=0)
            crossed = res <= tol * np.asarray(norm)
            newly = (first_it == 0) & crossed
            first_it[newly] = it
            it += 1
            if crossed.all() or it > max_it:
                break

        # solution update: x += M^-1 (V Y) + M^-1 (U Yu)  [coupled term]
        Yb = jnp.asarray(y.reshape(steps, bw, mu), dtype=dtype)
        # Z_i = M^-1 V_i: already in solution space — no further precondition
        upd = sum(jnp.einsum("sna,am->snm", Z[i], Yb[i])
                  for i in range(steps))
        if kc:
            # z-coefficients: zc = -B y (flattened over block columns);
            # U lives in operator space, so its correction goes through M^-1
            Bflat = Bb[:, :steps, :].reshape(kc, steps * bw)
            ymat = y[: steps * bw]
            zc = -(Bflat @ ymat)                      # (k, mu)
            upd = upd + prec(jnp.einsum("snk,km->snm", U,
                                        jnp.asarray(zc, dtype=dtype)))
        x = x + upd
        r = b - op.gmv(x)
        if C is not None:
            cr = _cross_j(op, C, r)
            x = x + prec(jnp.einsum("snk,km->snm", U, cr))
            r = r - jnp.einsum("snk,km->snm", C, cr)

        # recycle-space (re)construction (end of a full block cycle)
        if k and steps == p and (first_it == 0).any():
            pd = steps * bw
            Hflat = Hb[: steps + 1, :steps].transpose(0, 2, 1, 3).reshape(
                (steps + 1) * bw, pd)                 # block-major flatten
            Vp = jnp.concatenate(V[:steps], axis=-1)  # (S, n, p*mu)
            Vs = jnp.concatenate(V[: steps + 1], axis=-1)
            if C is None:
                # first cycle: block harmonic Ritz of the square Hessenberg
                # with the rank-mu correction Hsq^{-H} e_p (H_last^H H_last)
                Hsq = Hflat[:pd]
                Hlast = Hb[steps, steps - 1]          # (mu, mu)
                corr = np.zeros((pd, pd))
                try:
                    w_inv = np.linalg.solve(Hsq.T, np.eye(pd))
                    corr[:, -bw:] = w_inv[:, -bw:] @ (Hlast.T @ Hlast)
                except np.linalg.LinAlgError:
                    pass
                w_e, vr = np.linalg.eig(Hsq + corr)
                # recycle bK = bw*k columns (k block slots of the deflated
                # width, HPDDM_GCRODR.hpp:696 "int bK = deflated * k")
                idx = _select_ritz(w_e, min(k * bw, pd), target)
                P, _ = np.linalg.qr(np.real(vr[:, idx]))
                U_new = _lincomb_mat(Vp, jnp.asarray(P, dtype=dtype))
                Qs, Rs = np.linalg.qr(Hflat @ P)      # C = V_{p+1} Q
                C = _lincomb_mat(Vs, jnp.asarray(Qs, dtype=dtype))
                U = _solve_right_tri(U_new, np.asarray(Rs))
            else:
                # later cycles: coupled-projection pencil over [U, V_p]
                # (block form of HPDDM_GCRODR.hpp:745-850 / Parks strat. A):
                # op([U, V_p]) = [C, V_{p+1}] G, G = [[I_kc, B],[0, Hbar]]
                d = kc + pd
                Bflat = Bb[:, :steps, :].reshape(kc, pd)
                G = np.zeros((d + bw, d))
                G[:kc, :kc] = np.eye(kc)
                G[:kc, kc:] = Bflat
                G[kc:, kc:] = Hflat
                if strategy == "B":
                    QhW = None if bw == 1 else np.eye(d + bw, d)
                else:
                    CU = _cross(op, C, U)             # (kc, kc)
                    VU = _cross(op, Vs, U)            # ((p+1)mu, kc)
                    QhW = np.zeros((d + bw, d))
                    QhW[:kc, :kc] = CU
                    QhW[kc:, :kc] = VU
                    QhW[kc: kc + pd, kc:] = np.eye(pd)
                P = _harmonic_ritz_general(G, QhW, min(k * bw, d), target)
                U_new = (_lincomb_mat(U, jnp.asarray(P[:kc], dtype=dtype))
                         + _lincomb_mat(Vp, jnp.asarray(P[kc:], dtype=dtype)))
                GPq, GPr = np.linalg.qr(G @ P)
                C = (_lincomb_mat(C, jnp.asarray(GPq[:kc], dtype=dtype))
                     + _lincomb_mat(Vs, jnp.asarray(GPq[kc:], dtype=dtype)))
                U = _solve_right_tri(U_new, GPr)
        if (first_it > 0).all() or it > max_it:
            break

    rel = (np.asarray(res) / np.asarray(norm)) if res is not None \
        else np.full(mu, np.inf)
    its_arr = np.where(first_it > 0, first_it, min(it - 1, max_it))
    rec = RecycledSpace(U=U, C=C) if (k and U is not None) else None
    return GCRODRResult(x=x, iterations=jnp.int32(int(its_arr.max())),
                        it_per_rhs=jnp.asarray(its_arr, jnp.int32),
                        rel_res=jnp.asarray(rel),
                        converged=jnp.asarray(first_it > 0),
                        recycled=rec)


def _cross_j(op: LinearOperator, Cols: jax.Array, y: jax.Array) -> jax.Array:
    """(S,n,k)^H W y -> (k, mu) as a jax array."""
    w = op.weight[:, :, None] if op.weight is not None else 1.0
    from hpddm_tpu.parallel.ops import psum_if
    return psum_if(jnp.einsum("snk,snm->km", jnp.conj(Cols), w * y),
                   op.axis_name)


def bgcrodr(op: LinearOperator, b: jax.Array,
            x0: Optional[jax.Array] = None, tol: float = 1.0e-6,
            restart: int = 40, max_it: int = 100, variant: str = "right",
            recycle: int = 0, target: str = "SM",
            recycled: Optional[RecycledSpace] = None,
            same_system: bool = False, strategy: str = "A") -> "GCRODRResult":
    """Sequential multi-RHS GCRO-DR: columns solved one after another,
    sharing (and refining) one recycled space — later columns start warm.

    NOT dispatched from solve(): ``-hpddm_krylov_method bgcrodr`` with
    mu > 1 routes to :func:`bgcrodr_fused` (true block recycling,
    HPDDM_GCRODR.hpp:446-907) and ``gcrodr`` handles mu > 1 pseudo-block
    (simultaneous per-RHS spaces). Kept as a library entry point for the
    solve-columns-in-sequence usage where cross-column warm deflation is
    the goal (tests/test_block_gcrodr.py::test_bgcrodr_multi_rhs)."""
    S, n, mu = b.shape
    if mu == 1:
        return gcrodr(op, b, x0, tol, restart, max_it, variant, recycle,
                      target, False, recycled, same_system, strategy)
    xs, its, rels, convs = [], [], [], []
    rec = recycled
    for j in range(mu):
        bj = b[:, :, j: j + 1]
        xj = x0[:, :, j: j + 1] if x0 is not None else None
        res = gcrodr(op, bj, xj, tol, restart, max_it, variant, recycle,
                     target, False, rec, same_system or (j > 0), strategy)
        rec = res.recycled if res.recycled is not None else rec
        xs.append(res.x)
        its.append(int(res.iterations))
        rels.append(res.rel_res)
        convs.append(res.converged)
    x = jnp.concatenate(xs, axis=2)
    return GCRODRResult(x=x, iterations=jnp.int32(max(its)),
                        it_per_rhs=jnp.asarray(its, jnp.int32),
                        rel_res=jnp.concatenate(rels),
                        converged=jnp.concatenate(convs), recycled=rec)


def gcrodr(op: LinearOperator, b: jax.Array,
           x0: Optional[jax.Array] = None, tol: float = 1.0e-6,
           restart: int = 40, max_it: int = 100, variant: str = "right",
           recycle: int = 0, target: str = "SM", block: bool = False,
           recycled: Optional[RecycledSpace] = None,
           same_system: bool = False, strategy: str = "A") -> GCRODRResult:
    """Solve with GCRO-DR, pseudo-block over the trailing RHS axis.

    mu > 1 mirrors the reference's pseudo-block GCRODR
    (HPDDM_GCRODR.hpp:35-444: per-RHS interleaved Hessenberg ``H[i] + nu``,
    per-RHS recycled slabs ``U + nu * n`` regenerated in the
    ``for nu < mu`` loop at :249): every RHS keeps its own Hessenberg,
    Givens rotations, and recycled (U, C) pair, while the operator and
    preconditioner applications are fused over all RHS in one batched
    call. Internally U and C are (S, n, k, mu); a stored mu=1 space is
    exposed as (S, n, k) for compatibility and broadcast to mu > 1 on
    entry (each RHS then refines its own copy)."""
    del block  # BGCRODR shares this code path for now via mu-fused blocks
    if x0 is None:
        x0 = jnp.zeros_like(b)
    S, n, mu = b.shape
    dtype = b.dtype
    rdtype = underlying(dtype)
    m = int(restart)
    k = int(min(recycle, m - 1)) if recycle else 0
    left = variant == "left"

    def prec(x):
        return op.apply(x)

    def op_apply(x):  # the preconditioned operator
        return prec(op.gmv(x)) if left else op.gmv(prec(x))

    b_eff = prec(b) if left else b
    norm = jnp.sqrt(op.init_norm_sq(b_eff)).astype(rdtype)     # (mu,)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    x = x0
    r = b_eff - (prec(op.gmv(x)) if left else op.gmv(x))

    U = C = None
    if k and recycled is not None and recycled.U is not None:
        U, C = recycled.U, recycled.C
        if U.ndim == 3:                       # stored mu=1 layout (S, n, k)
            U, C = U[..., None], C[..., None]
        if U.shape[-1] == 1 and mu > 1:       # broadcast to every RHS
            U = jnp.tile(U, (1, 1, 1, mu))
            C = jnp.tile(C, (1, 1, 1, mu))
        if U.shape[-1] != mu or U.shape[2] != k:
            U = C = None                      # incompatible stored space
    if U is not None:
        if not same_system:
            # re-project for the (possibly) new operator: C = Q of op(U)
            AU = _apply_cols_mu(op_apply, U)
            C, Rfac = _tall_qr_mu(op, AU)
            U = _solve_right_tri_mu(U, Rfac)
        cr = _gram_cols(op, C, r)                              # (k, mu)
        Ucr = jnp.einsum("snkm,km->snm", U, cr)
        x = x + (Ucr if left else prec(Ucr))
        r = r - jnp.einsum("snkm,km->snm", C, cr)

    it = 1
    first_it = np.zeros(mu, dtype=np.int64)
    total_cap = int(max_it)

    while it <= total_cap:
        p = m - (k if U is not None else 0)
        beta = jnp.sqrt(op.norm_sq(r)).astype(rdtype)          # (mu,)
        if it > 1 and bool(
                np.all(np.asarray(beta) <= float(tol) * np.asarray(norm))):
            break
        V, H_np, B_np, crossing, _ = _arnoldi_cycle(
            op, op_apply, r, beta, p, U, C, float(tol), np.asarray(norm),
            it, total_cap)
        # H: (p+1, p, mu) numpy, B: (k, p, mu) numpy, crossing: (mu,) first
        # global it index crossing tol within this cycle (0 if none)
        steps = min(p, total_cap - it + 1)
        if np.all(crossing > 0):
            used = int(crossing.max() - it + 1)
        else:
            used = steps
        used = max(min(used, steps), 0)

        # per-RHS LS solves on the small systems
        beta_np = np.asarray(beta)
        y = np.zeros((p, mu), dtype=H_np.dtype)
        for nu in range(mu):
            y[:, nu], _ = _ls_solve(H_np[:, :, nu], float(beta_np[nu]), used)
        dx_coef = jnp.asarray(y, dtype=dtype)
        upd = jnp.einsum("jm,jsnm->snm", dx_coef, V[:p])
        if U is not None:
            z_coef = -np.einsum("kjm,jm->km", B_np[:, :used], y[:used])
            upd = upd + jnp.einsum("snkm,km->snm", U,
                                   jnp.asarray(z_coef, dtype=dtype))
        x = x + (upd if left else prec(upd))
        r = b_eff - (prec(op.gmv(x)) if left else op.gmv(x))

        newly = (first_it == 0) & (crossing > 0)
        first_it[newly] = crossing[newly]

        # --- recycle-space update (end of a full cycle), per RHS --------
        if k and used == p:
            if U is None:
                # first cycle: harmonic Ritz of each RHS's Hessenberg
                kk = min(k, p)
                P_all = np.zeros((p, kk, mu), dtype=H_np.dtype)
                Qs_all = np.zeros((p + 1, kk, mu), dtype=H_np.dtype)
                Rs_all = np.zeros((kk, kk, mu), dtype=H_np.dtype)
                for nu in range(mu):
                    P_nu = _harmonic_ritz_first(H_np[:, :, nu], p, kk, target)
                    Qs, Rs = np.linalg.qr(H_np[: p + 1, :p, nu] @ P_nu)
                    P_all[:, :, nu] = P_nu
                    Qs_all[:, :, nu] = Qs
                    Rs_all[:, :, nu] = Rs
                U_new = jnp.einsum("jkm,jsnm->snkm",
                                   jnp.asarray(P_all, dtype=dtype), V[:p])
                C = jnp.einsum("jkm,jsnm->snkm",
                               jnp.asarray(Qs_all, dtype=dtype), V[: p + 1])
                U = _solve_right_tri_mu(U_new, Rs_all)
            else:
                d = k + p
                if strategy == "B":
                    CU = VU = None
                else:
                    # Q^H W cross products (the reference's allreduced "prod")
                    CU = _cross_mu(op, C, U)                  # (k, k, mu)
                    VU = _cross_stack_mu(op, V[: p + 1], U)   # (p+1, k, mu)
                P_all = np.zeros((d, k, mu), dtype=H_np.dtype)
                GPq_all = np.zeros((d + 1, k, mu), dtype=H_np.dtype)
                GPr_all = np.zeros((k, k, mu), dtype=H_np.dtype)
                for nu in range(mu):
                    # G = [[I_k, B],[0, Hbar]] : (d+1, d)
                    G = np.zeros((d + 1, d), dtype=H_np.dtype)
                    G[:k, :k] = np.eye(k)
                    G[:k, k:] = B_np[:, :, nu]
                    G[k:, k:] = H_np[:, :, nu]
                    if strategy == "B":
                        # strategy B: no Q^H W cross products / global reduce
                        QhW = None
                    else:
                        QhW = np.zeros((d + 1, d), dtype=H_np.dtype)
                        QhW[:k, :k] = CU[:, :, nu]
                        QhW[k: d + 1, :k] = VU[:, :, nu]
                        QhW[k: d, k:] = np.eye(p)
                    P_nu = _harmonic_ritz_general(G, QhW, k, target)
                    GPq, GPr = np.linalg.qr(G @ P_nu)
                    P_all[:, :, nu] = P_nu
                    GPq_all[:, :, nu] = GPq
                    GPr_all[:, :, nu] = GPr
                # W P = U P_u + V_p P_v, per RHS
                P_u = jnp.asarray(P_all[:k], dtype=dtype)
                P_v = jnp.asarray(P_all[k:], dtype=dtype)
                U_new = (jnp.einsum("kjm,snkm->snjm", P_u, U)
                         + jnp.einsum("pjm,psnm->snjm", P_v, V[:p]))
                Q_c = jnp.asarray(GPq_all[:k], dtype=dtype)
                Q_v = jnp.asarray(GPq_all[k:], dtype=dtype)
                C = (jnp.einsum("kjm,snkm->snjm", Q_c, C)
                     + jnp.einsum("pjm,psnm->snjm", Q_v, V[: p + 1]))
                U = _solve_right_tri_mu(U_new, GPr_all)

        it += used
        if np.all(first_it > 0):
            break
        if used < steps or used == 0:
            break

    rel = jnp.sqrt(op.norm_sq(r)).astype(rdtype) / norm
    its_arr = np.where(first_it > 0, first_it, min(it - 1, total_cap))
    rec = None
    if k and U is not None:
        rec = RecycledSpace(U=U[..., 0] if mu == 1 else U,
                            C=C[..., 0] if mu == 1 else C)
    return GCRODRResult(x=x, iterations=jnp.int32(int(its_arr.max())),
                        it_per_rhs=jnp.asarray(its_arr, jnp.int32),
                        rel_res=rel,
                        converged=rel <= tol, recycled=rec)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _cols_to_stack(U: jax.Array) -> jax.Array:
    """(S, n, k) -> (k, S, n, 1) stack layout used by op.gram."""
    return jnp.moveaxis(U, -1, 0)[:, :, :, None]


def _lincomb(U: jax.Array, coef: jax.Array) -> jax.Array:
    """(S, n, k) x (k,) -> (S, n, 1)."""
    return jnp.einsum("snk,k->sn", U, coef)[:, :, None]


def _lincomb_mat(U: jax.Array, P: jax.Array) -> jax.Array:
    """(S, n, k) x (k, k2) -> (S, n, k2)."""
    return jnp.einsum("snk,kj->snj", U, P)


def _apply_cols(fn, U: jax.Array) -> jax.Array:
    cols = [fn(U[:, :, i: i + 1])[:, :, 0] for i in range(U.shape[-1])]
    return jnp.stack(cols, axis=-1)


def _cross(op: LinearOperator, A: jax.Array, Bm: jax.Array) -> np.ndarray:
    """(S,n,k1)^H W (S,n,k2) weighted -> numpy (k1, k2)."""
    w = op.weight[:, :, None] if op.weight is not None else 1.0
    local = jnp.einsum("snk,snj->kj", jnp.conj(A), w * Bm)
    from hpddm_tpu.parallel.ops import psum_if
    return np.asarray(psum_if(local, op.axis_name))


def _cross_stack(op: LinearOperator, V: jax.Array, U: jax.Array) -> np.ndarray:
    """V (j, S, n, 1) stack vs U (S, n, k) -> numpy (j, k)."""
    w = op.weight[:, :, None] if op.weight is not None else 1.0
    local = jnp.einsum("jsnm,snk->jk", jnp.conj(V), (w * U)[:, :, :])
    from hpddm_tpu.parallel.ops import psum_if
    return np.asarray(psum_if(local, op.axis_name))


def _tall_qr(op: LinearOperator, U: jax.Array) -> Tuple[jax.Array, np.ndarray]:
    """Distributed CholQR of (S, n, k) in the weighted inner product,
    eigh-based for robustness to near-dependent columns."""
    G = _cross(op, U, U)
    G = 0.5 * (G + G.conj().T)
    w, V = np.linalg.eigh(G)
    wmax = max(float(np.max(np.abs(w))), 1e-300)
    keep = w > 1e-12 * wmax
    sqrt_w = np.sqrt(np.where(keep, w, 1.0))
    R = (V * np.where(keep, sqrt_w, 0.0)[None, :]) @ V.conj().T
    Rinv = (V * np.where(keep, 1.0 / sqrt_w, 0.0)[None, :]) @ V.conj().T
    return _lincomb_mat(U, jnp.asarray(Rinv, dtype=U.dtype)), R


def _solve_right_tri(U: jax.Array, R: np.ndarray) -> jax.Array:
    return _lincomb_mat(U, jnp.asarray(np.linalg.pinv(R), dtype=U.dtype))


# -- per-RHS (pseudo-block) variants: U/C carry a trailing mu axis --------

def _gram_cols(op: LinearOperator, Cols: jax.Array, y: jax.Array) -> jax.Array:
    """Per-RHS weighted Gram: Cols (S,n,k,mu)^H W y (S,n,mu) -> (k, mu)."""
    yw = op.weight[:, :, None] * y if op.weight is not None else y
    from hpddm_tpu.parallel.ops import psum_if
    return psum_if(jnp.einsum("snkm,snm->km", jnp.conj(Cols), yw),
                   op.axis_name)


def _apply_cols_mu(fn, U: jax.Array) -> jax.Array:
    """Apply fn to each of the k per-RHS column groups of (S, n, k, mu)."""
    cols = [fn(U[:, :, j, :]) for j in range(U.shape[2])]
    return jnp.stack(cols, axis=2)


def _cross_mu(op: LinearOperator, A: jax.Array, Bm: jax.Array) -> np.ndarray:
    """(S,n,k1,mu)^H W (S,n,k2,mu) per-RHS -> numpy (k1, k2, mu)."""
    w = op.weight[:, :, None, None] if op.weight is not None else 1.0
    local = jnp.einsum("snkm,snjm->kjm", jnp.conj(A), w * Bm)
    from hpddm_tpu.parallel.ops import psum_if
    return np.asarray(psum_if(local, op.axis_name))


def _cross_stack_mu(op: LinearOperator, V: jax.Array,
                    U: jax.Array) -> np.ndarray:
    """V (j, S, n, mu) stack vs U (S, n, k, mu) per-RHS -> numpy (j, k, mu)."""
    w = op.weight[:, :, None, None] if op.weight is not None else 1.0
    local = jnp.einsum("jsnm,snkm->jkm", jnp.conj(V), w * U)
    from hpddm_tpu.parallel.ops import psum_if
    return np.asarray(psum_if(local, op.axis_name))


def _tall_qr_mu(op: LinearOperator,
                U: jax.Array) -> Tuple[jax.Array, np.ndarray]:
    """Per-RHS distributed CholQR of (S, n, k, mu) in the weighted inner
    product (eigh-based, as _tall_qr). Returns (Q (S,n,k,mu), R (k,k,mu))."""
    G = _cross_mu(op, U, U)
    kdim, _, mu = G.shape
    R = np.zeros_like(G)
    Rinv = np.zeros_like(G)
    for nu in range(mu):
        Gn = 0.5 * (G[:, :, nu] + G[:, :, nu].conj().T)
        w, Vv = np.linalg.eigh(Gn)
        wmax = max(float(np.max(np.abs(w))), 1e-300)
        keep = w > 1e-12 * wmax
        sqrt_w = np.sqrt(np.where(keep, w, 1.0))
        R[:, :, nu] = (Vv * np.where(keep, sqrt_w, 0.0)[None, :]) @ \
            Vv.conj().T
        Rinv[:, :, nu] = (Vv * np.where(keep, 1.0 / sqrt_w, 0.0)[None, :]) @ \
            Vv.conj().T
    Q = jnp.einsum("snkm,kjm->snjm", U, jnp.asarray(Rinv, dtype=U.dtype))
    return Q, R


def _solve_right_tri_mu(U: jax.Array, R: np.ndarray) -> jax.Array:
    """Per-RHS right-multiply by pinv(R): U (S,n,k,mu), R (k,k,mu)."""
    Rp = np.stack([np.linalg.pinv(R[:, :, nu]) for nu in range(R.shape[2])],
                  axis=-1)
    return jnp.einsum("snkm,kjm->snjm", U, jnp.asarray(Rp, dtype=U.dtype))


def _ls_solve(H: np.ndarray, beta: float, used: int):
    """min || beta e1 - H[:used+1, :used] y ||; returns (y (p,), residual)."""
    p = H.shape[1]
    y = np.zeros(p, dtype=H.dtype)
    if used == 0:
        return y, beta
    Hs = H[: used + 1, :used]
    rhs = np.zeros(used + 1, dtype=H.dtype)
    rhs[0] = beta
    sol, res, *_ = np.linalg.lstsq(Hs, rhs, rcond=None)
    y[:used] = sol
    return y, float(np.linalg.norm(rhs - Hs @ sol))


def _arnoldi_cycle(op: LinearOperator, op_apply, r: jax.Array, beta,
                   p: int, U: Optional[jax.Array], C: Optional[jax.Array],
                   tol: float, norm: np.ndarray, it0: int, max_it: int):
    """One projected Arnoldi cycle, pseudo-block over the trailing mu axis;
    jit-compiled body, eager wrapper. Each RHS carries its own Hessenberg
    column, Givens rotations, and residual, while the operator application
    is fused (HPDDM_GCRODR.hpp:115-197 iterates ``nu < mu`` around one
    batched GMV).

    Returns (V (p+1, S, n, mu), H (p+1, p, mu) np, B (k, p, mu) np,
    crossing (mu,) np, res (mu,))."""
    S, n, mu = r.shape
    dtype = r.dtype
    k = U.shape[2] if U is not None else 0    # U: (S, n, k, mu)

    safe_beta = jnp.where(beta > 0, beta, 1.0)
    v0 = r / safe_beta
    norm_j = jnp.asarray(norm)

    def body(carry, i, C, norm_j, it0):
        V, H, B, s_vec, Q, crossing = carry
        vi = V[i]
        w = op_apply(vi)
        if C is not None:
            Bcol = _gram_cols(op, C, w)                     # (k, mu)
            w = w - jnp.einsum("snkm,km->snm", C, Bcol)
        else:
            Bcol = jnp.zeros((0, mu), dtype=dtype)
        mask = (jnp.arange(p + 1) <= i)[:, None]
        h = op.gram(V, w)                                   # (p+1, mu)
        h = jnp.where(mask, h, 0)
        w = w - jnp.einsum("km,ksnm->snm", h, V)
        hn = jnp.sqrt(op.norm_sq(w)).astype(dtype)          # (mu,)
        safe_hn = jnp.where(jnp.abs(hn) > 0, hn, 1.0)
        V = V.at[i + 1].set(w / safe_hn)
        hcol = h.at[i + 1].set(hn)                          # (p+1, mu)

        # accumulated rotation product, per RHS (see solvers/gmres.py)
        hrot = jnp.einsum("abm,bm->am", Q, hcol)
        hi, hi1 = hrot[i], hrot[i + 1]                      # (mu,)
        denom = jnp.sqrt(jnp.abs(hi) ** 2 + jnp.abs(hi1) ** 2)
        safe_d = jnp.where(denom > 0, denom, 1.0)
        c_new = jnp.where(denom > 0, hi / safe_d, 1.0)
        s_new = jnp.where(denom > 0, hi1 / safe_d, 0.0)
        qi, qi1 = Q[i], Q[i + 1]                            # (p+1, mu)
        Q = Q.at[i].set(jnp.conj(c_new) * qi + jnp.conj(s_new) * qi1) \
             .at[i + 1].set(-s_new * qi + c_new * qi1)
        si = s_vec[i]
        s_vec = s_vec.at[i + 1].set(-s_new * si).at[i].set(jnp.conj(c_new) * si)
        res = jnp.abs(s_vec[i + 1])                         # (mu,)
        glob_it = (it0 + i).astype(jnp.int32)
        hit = (res <= tol * norm_j) & (crossing == 0) & (glob_it <= max_it)
        crossing = jnp.where(hit, glob_it, crossing)
        # store the *unrotated* column; the LS solve uses H directly
        H = H.at[:, i].set(hcol)
        B = B.at[:, i].set(Bcol) if k else B
        return (V, H, B, s_vec, Q, crossing), res

    # v0 and C are passed as jit arguments (never closure-captured): at
    # flagship scale they are the dominant state and an embedded HLO
    # literal both inflates the compile and forces a recompile every
    # cycle (r changes each restart).
    @jax.jit
    def run(v0, beta, C_arg, norm_j, it0):
        V0 = jnp.zeros((p + 1, S, n, mu), dtype=dtype).at[0].set(v0)
        H0 = jnp.zeros((p + 1, p, mu), dtype=dtype)
        B0 = jnp.zeros((k, p, mu), dtype=dtype)
        s0 = jnp.zeros((p + 1, mu), dtype=dtype).at[0].set(beta.astype(dtype))
        Q0 = jnp.broadcast_to(jnp.eye(p + 1, dtype=dtype)[:, :, None],
                              (p + 1, p + 1, mu))
        (V, H, B, s_vec, Q, crossing), res_seq = lax.scan(
            lambda carry, i: body(carry, i, C_arg, norm_j, it0),
            (V0, H0, B0, s0, Q0, jnp.zeros((mu,), jnp.int32)),
            jnp.arange(p))
        return V, H, B, crossing, res_seq

    V, H, B, crossing, res_seq = run(
        v0, jnp.asarray(beta), C, norm_j, jnp.asarray(it0, jnp.int32))
    return (V, np.asarray(H), np.asarray(B), np.asarray(crossing),
            np.asarray(res_seq)[-1])
