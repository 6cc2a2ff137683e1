"""One- and two-level overlapping Schwarz preconditioners.

Re-design of ``Schwarz<Solver, CoarseOperator, S, K>``
(include/HPDDM_schwarz.hpp:86-803). The preconditioner state is a pytree of
batched arrays (leading axis = subdomains, shardable over a mesh axis); the
runtime methods are pure jittable functions:

* ``apply``  — M^-1 with variants RAS/ASM/ORAS/SORAS/none
  (HPDDM_schwarz.hpp:527-612) and coarse corrections
  deflated/additive/balanced,
* ``gmv``    — global SpMV = local SpMM + POU-scaled sum-exchange
  (HPDDM_schwarz.hpp:726-747),
* ``deflation`` — coarse correction Z E^-1 Z^T D (HPDDM_schwarz.hpp:
  1602-1622); the coarse matrix E = Z^T A Z is assembled with batched
  einsums + one psum and replicated on every device, removing the reference's
  gather -> main-process direct solve -> scatter latency
  (HPDDM_coarse_operator_impl.hpp:1630-1732),
* ``compute_residual`` — independent residual recomputation
  (HPDDM_schwarz.hpp:761-803).

The local direct solves delegate to batched factorizations
(ops/local_solve.py, ops/banded_solve.py) instead of
MUMPS/PARDISO/SuiteSparse.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import os

import jax
import jax.numpy as jnp
import numpy as np

from hpddm_tpu.core.csr import MatrixCSR
from hpddm_tpu.core.formats import (BatchedDense, batched_dense_from,
                                    pack_local_matrices)
from hpddm_tpu.dtypes import HPDDM_EPS, HPDDM_PEN
from hpddm_tpu.ops.local_solve import LocalSolver, factorize
from hpddm_tpu.ops.spmv import spmm
from hpddm_tpu.options import Options
from hpddm_tpu.parallel.decomposition import Decomposition, restrict_pou \
    as _restrict_pou
from hpddm_tpu.parallel.ops import exchange, psum_if, scaled_exchange


# dense Galerkin assembly memory cap: above this the coarse build
# auto-switches to the block-sparse path (see Schwarz._build_coarse)
_DENSE_COARSE_BYTES_CAP = 2 << 30

# identity-compared sentinel for the boundary-condition memo: the cached
# value may be a jnp array (comparing one to a tuple raises)
_BC_UNSET = object()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoarseState:
    """Two-level (GenEO or user) coarse-space state, replicated coarse solve.

    mode 'direct': E_inv holds the dense inverse (the analogue of a main-
    process direct factorization, HPDDM_coarse_operator_impl.hpp:1630).
    mode 'iterative': E is kept and each coarse solve runs a nested
    block-Jacobi-preconditioned Krylov iteration with its own level-2
    options — the HPDDM_INEXACT_COARSE_OPERATOR analogue
    (include/HPDDM_inexact_coarse_operator.hpp:741-778).
    mode 'bsr': E is *neighbor-block-sparse* — only the diagonal and
    neighbor blocks E_ij = (A^T D Z)_i[shared]^T (D Z)_j[shared] are
    assembled (the reference's sparsity pattern 's',
    HPDDM_operator.hpp:378-562) and the coarse solve is the nested Krylov
    with a block-sparse matvec. Memory and assembly are O(S * neighbors),
    not O(S^2) — the path to thousands of subdomains."""
    Z: jax.Array                  # (S, n_max, nu_max) local deflation vectors
    E_inv: Optional[jax.Array]    # (N_c, N_c) inverse (direct) or
    #                               block-Jacobi inverse (iterative)
    nu_loc: jax.Array             # (S,) int32 — actual nu per subdomain
    E: Optional[jax.Array]        # (N_c, N_c) coarse matrix (iterative only)
    nu_max: int = dataclasses.field(metadata=dict(static=True))
    correction: str = dataclasses.field(metadata=dict(static=True))
    # 'deflated' | 'additive' | 'balanced' (HPDDM_SCHWARZ_COARSE_CORRECTION_*)
    mode: str = dataclasses.field(default="direct", metadata=dict(static=True))
    inner_tol: float = dataclasses.field(default=1.0e-2,
                                         metadata=dict(static=True))
    inner_max_it: int = dataclasses.field(default=50,
                                          metadata=dict(static=True))
    # inexact-coarse solve configuration (level-2 options): the nested
    # solve dispatches through the same solvers/ stack as the fine level —
    # the reference recursion IterativeMethod::solve on the coarse matrix
    # (HPDDM_inexact_coarse_operator.hpp:741-778).
    method: str = dataclasses.field(default="cg",
                                    metadata=dict(static=True))
    restart: int = dataclasses.field(default=30,
                                     metadata=dict(static=True))
    # level-2 preconditioner: 'bj' block-Jacobi (= RAS with zero overlap),
    # 'ras'/'asm' one-level block Schwarz with neighbor-block overlap
    # (level_2_schwarz_method), 'none' identity
    prec: str = dataclasses.field(default="bj", metadata=dict(static=True))
    # third level (buildThree, HPDDM_inexact_coarse_operator.hpp:1328):
    # aggregate-constant deflation of E; the level-3 system is solved
    # 'direct' (prefactorized), 'cg' (nested Jacobi-CG with level_3_tol /
    # level_3_max_it), or 'none' (disabled)
    lvl3: str = dataclasses.field(default="direct",
                                  metadata=dict(static=True))
    l3_tol: float = dataclasses.field(default=1.0e-2,
                                      metadata=dict(static=True))
    l3_max_it: int = dataclasses.field(default=20,
                                       metadata=dict(static=True))
    E2_inv: Optional[jax.Array] = None   # (n3, n3) inverse of Z2^T E Z2
    #                                      (or its Jacobi inverse, lvl3='cg')
    Z2: Optional[jax.Array] = None       # (N_c, n3) aggregate indicators
    E2: Optional[jax.Array] = None       # (n3, n3) level-3 matrix (lvl3='cg')
    # overlapping-block Schwarz data (prec 'ras'/'asm')
    Eloc_inv: Optional[jax.Array] = None  # (S, L, L) local inverses
    loc_idx: Optional[jax.Array] = None   # (S, L) coarse-row gather (dense)
    # (S, nu_max, n3) level-3 deflation basis for the bsr coarse solve:
    # constant-per-aggregate indicators by default, or per-aggregate
    # spectral vectors (smallest eigenpairs of the aggregate-local coarse
    # operator) when -hpddm_level_3_geneo_nu is set — the recursion of the
    # reference's spectral machinery onto the coarse operator
    # (HPDDM_inexact_coarse_operator.hpp:1328, HPDDM_schwarz.hpp:449-495)
    agg_oh: Optional[jax.Array] = None
    # block-sparse coarse (mode 'bsr'); all leaves S-leading -> sharded
    Eb_diag: Optional[jax.Array] = None      # (S, nu, nu)
    Eb_nbr: Optional[jax.Array] = None       # (S, K, nu, nu)
    Eb_diag_inv: Optional[jax.Array] = None  # (S, nu, nu) block Jacobi
    nbr_oh: Optional[jax.Array] = None       # (S, K, S+1) one-hot of the
    #                                          neighbor subdomain ids
    # levels 4+ (round 4): the generalized buildThree recursion honoring
    # level_[4-9]\d*_ prefixes (HPDDM_option_impl.hpp:27;
    # PETSC_PCHPDDM_MAXLEVELS analogue). Chain entry j belongs to level
    # 4+j: chain_Z[j] maps the level-(3+j) space into the level-(4+j)
    # aggregate space, chain_E[j] is the Galerkin matrix there, and
    # chain_inv[j] is its prefactorized inverse (mode 'direct', ending
    # the recursion) or its Jacobi inverse (mode 'cg', whose deflated CG
    # is corrected by level 5+j, and so on).
    chain_Z: tuple = ()
    chain_E: tuple = ()
    chain_inv: tuple = ()
    chain_modes: tuple = dataclasses.field(default=(),
                                           metadata=dict(static=True))
    chain_tols: tuple = dataclasses.field(default=(),
                                          metadata=dict(static=True))
    chain_max_its: tuple = dataclasses.field(default=(),
                                             metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SchwarzState:
    dec: Decomposition
    A: object                     # batched local matrices (DIA/ELL/Dense)
    solver: LocalSolver
    coarse: Optional[CoarseState]
    variant: str = dataclasses.field(metadata=dict(static=True))
    # 'ras' | 'asm' | 'oras' | 'soras' | 'osm' | 'none'
    # (Prcndtnr::{GE,SY,OG,OS,NO}, HPDDM_schwarz.hpp:104-110)
    # Dirichlet boundary-condition values per row (Subdomain::boundaryCond,
    # HPDDM_subdomain.hpp:310-336): a_ii on detected boundary rows, 0
    # elsewhere; None when no such rows exist. Used by `start` to seed the
    # initial guess exactly on penalized/identity rows.
    bc: Optional[jax.Array] = None


# ----------------------------------------------------------------------
# Runtime (pure functions over SchwarzState)
# ----------------------------------------------------------------------

def gmv(state: SchwarzState, x: jax.Array,
        axis_name: Optional[str] = None) -> jax.Array:
    """Global SpMV on a consistent input: local SpMM then scaled exchange.

    Correct because the POU vanishes on each subdomain's artificial boundary,
    exactly where the local rows are incomplete (HPDDM_schwarz.hpp:726-747).

    Multi-RHS canvas fast path: on grid decompositions the whole product
    runs with the RHS axis *leading* — one transpose in, one out — so
    neither the canvas SpMM nor the halo exchange ever holds mu in the
    minor dimension (the trailing-mu layout relayouts every canvas op)."""
    from hpddm_tpu.core.formats import BatchedDIA
    dec = state.dec
    mu = x.shape[-1]
    if (mu > 1 and isinstance(state.A, BatchedDIA)
            and state.A.canvas_hw is not None
            and dec.grid is not None and not dec.renumbered):
        from hpddm_tpu.ops.spmv import (dia_canvas_moves,
                                        spmm_dia_canvas_muT,
                                        spmm_dia_canvas_muT_scan)
        if dia_canvas_moves(state.A.offsets,
                            state.A.canvas_hw[1]) is not None:
            from hpddm_tpu.parallel.grid import (grid_exchange_muT,
                                                 grid_exchange_muT_scan)
            xT = jnp.moveaxis(x, -1, 1)                  # (S, mu, n)
            # scan pays per-step overheads: it only wins once the fused
            # form's (S, mu, n) accumulator spills; the 64 MB gate is not
            # yet measured on the GPU (ROADMAP S5)
            env = os.environ.get("HPDDM_TPU_MUT_SCAN")  # A/B override
            big = x.size * x.dtype.itemsize > 64 * 1024 * 1024
            if mu >= 3 and (env == "1" or (big and env != "0")):
                # mu >= 3 can spill the fused muT accumulator; lax.scan
                # over RHS groups runs each group as a mu<=2 pass and
                # cannot be interleaved back into a spilling schedule
                # (tools/bench_mut.py measures both)
                yT = spmm_dia_canvas_muT_scan(state.A, xT, pair=2,
                                              scale=dec.d)
                yT = grid_exchange_muT_scan(dec.grid, yT, axis_name)
            else:
                yT = spmm_dia_canvas_muT(state.A, xT) * dec.d[:, None, :]
                yT = grid_exchange_muT(dec.grid, yT, axis_name)
            return jnp.moveaxis(yT, 1, -1)
    y = spmm(state.A, x)
    return scaled_exchange(state.dec, y, axis_name)


def one_level_apply(state: SchwarzState, x: jax.Array,
                    axis_name: Optional[str] = None) -> jax.Array:
    """One-level M^-1 (HPDDM_schwarz.hpp:532-546)."""
    dec = state.dec
    v = state.variant
    if v == "none":
        return x
    if v in ("ras", "oras"):
        out = state.solver.solve(x)
        return scaled_exchange(dec, out, axis_name)          # out = sum R^T D A_loc^-1 x
    if v == "soras":
        out = dec.d[:, :, None] * x
        out = state.solver.solve(out)
        out = dec.d[:, :, None] * out
        return exchange(dec, out, axis_name)                 # out = sum R^T D A^-1 D x
    # asm / osm
    out = state.solver.solve(x)
    return exchange(dec, out, axis_name)                     # out = sum R^T A_loc^-1 x


def deflation(state: SchwarzState, x: jax.Array,
              axis_name: Optional[str] = None) -> jax.Array:
    """Coarse correction out = Z E^-1 Z^T D x (HPDDM_schwarz.hpp:1602-1622).

    The coarse solve is replicated: every device holds E^-1 (nu*S square,
    small; optionally in lower precision) and the coarse RHS is reduced with
    one psum — no gather/scatter round-trip.
    """
    co = state.coarse
    dec = state.dec
    dx = dec.d[:, :, None] * x                               # D x
    # coarse RHS c[(s,a)] = Z_s[:,a]^T (D x)_s  -> (S, nu, mu)
    c_loc = jnp.einsum("sna,snm->sam", jnp.conj(co.Z), dx)
    S_loc = x.shape[0]
    mu = x.shape[-1]
    if co.mode == "bsr":
        # block-sparse coarse: the RHS/solution stay block-sharded; only
        # the (tiny) block vectors are all_gathered inside the matvec
        y_loc = _coarse_solve_bsr(co, c_loc, axis_name).astype(x.dtype)
        out = jnp.einsum("sna,sam->snm", co.Z, y_loc)
        return scaled_exchange(dec, out, axis_name)
    if axis_name is None:
        c = c_loc.reshape(-1, mu)                            # (N_c, mu)
    else:
        # all_gather over the mesh axis -> full coarse RHS on every device.
        # For a *replicated* coarse factorization this is volume-optimal:
        # every device must end up with all N_c entries, and all_gather's
        # per-device receive volume (N_c - N_c/P) is the lower bound (a
        # psum of padded slot vectors would move ~2x that). Coarse solves
        # whose RHS must stay distributed use mode="bsr" above.
        c = jax.lax.all_gather(c_loc, axis_name, axis=0, tiled=True)
        c = c.reshape(-1, mu)
    y = _coarse_solve(co, c).astype(x.dtype)                 # (N_c, mu)
    y = y.reshape(-1, co.nu_max, mu)                         # (S, nu, mu)
    if axis_name is None:
        y_loc = y
    else:
        from hpddm_tpu.parallel.ops import axis_index_of
        idx = axis_index_of(axis_name)
        y_loc = jax.lax.dynamic_slice_in_dim(y, idx * S_loc, S_loc, axis=0)
    out = jnp.einsum("sna,sam->snm", co.Z, y_loc)            # Z y
    return scaled_exchange(dec, out, axis_name)


def _defl_jacobi_cg(E: jax.Array, Jinv: jax.Array, rc: jax.Array,
                    tol: float, max_it: int, defl) -> jax.Array:
    """Jacobi-preconditioned CG on E w = rc (rc: (n, mu)), optionally
    deflated by ``defl = (Z_next, solve_next)`` — the preconditioner
    becomes Jinv + Z_next solve_next(Z_next^H r), i.e. the next coarser
    level's correction. The recursion unit of the level-N chain."""
    def prec(r):
        z = Jinv @ r
        if defl is not None:
            Zn, slv = defl
            z = z + Zn @ slv(Zn.conj().T @ r)
        return z

    norm = jnp.sqrt(jnp.sum(jnp.abs(rc) ** 2, axis=0))
    norm = jnp.where(norm > 0, norm, 1.0)

    def cond(carry):
        w, r, p, rz, it = carry
        res = jnp.sqrt(jnp.sum(jnp.abs(r) ** 2, axis=0)) / norm
        return (it < max_it) & jnp.any(res > tol)

    def body(carry):
        w, r, p, rz, it = carry
        Ep = E @ p
        pq = jnp.sum(jnp.conj(p) * Ep, axis=0)
        alpha = rz / jnp.where(jnp.abs(pq) > 0, pq, 1.0)
        w = w + alpha[None, :] * p
        r = r - alpha[None, :] * Ep
        z = prec(r)
        rz_new = jnp.sum(jnp.conj(r) * z, axis=0)
        beta = rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0)
        p = z + beta[None, :] * p
        return (w, r, p, rz_new, it + 1)

    z0 = prec(rc)
    rz0 = jnp.sum(jnp.conj(rc) * z0, axis=0)
    w, *_ = jax.lax.while_loop(
        cond, body, (jnp.zeros_like(rc), rc, z0, rz0, jnp.int32(0)))
    return w


def _solve_chain(co: CoarseState, j: int, rc: jax.Array) -> jax.Array:
    """Solve the level-(4+j) system chain_E[j] w = rc (statically unrolled
    recursion over the per-level chain)."""
    if co.chain_modes[j] == "direct":
        return co.chain_inv[j] @ rc
    defl = None
    if j + 1 < len(co.chain_modes):
        defl = (co.chain_Z[j + 1], lambda r: _solve_chain(co, j + 1, r))
    return _defl_jacobi_cg(co.chain_E[j], co.chain_inv[j], rc,
                           co.chain_tols[j], co.chain_max_its[j], defl)


def _solve_level3(co: CoarseState, rc: jax.Array) -> jax.Array:
    """Solve the level-3 aggregate system E2 w = rc (rc: (n3, mu)).

    'direct': prefactorized inverse. 'cg': nested Jacobi-preconditioned CG
    with the level-3 options — the recursion of buildThree
    (HPDDM_inexact_coarse_operator.hpp:741-778,1328) one level down; when
    levels 4+ are configured (level_[4-9]_ options), the CG is deflated
    by the next level of the chain, recursively."""
    if co.lvl3 == "direct":
        return co.E2_inv @ rc
    defl = None
    if len(co.chain_modes):
        defl = (co.chain_Z[0], lambda r: _solve_chain(co, 0, r))
    return _defl_jacobi_cg(co.E2, co.E2_inv, rc, co.l3_tol, co.l3_max_it,
                           defl)


def _coarse_solve(co: CoarseState, c: jax.Array,
                  return_its: bool = False):
    """Solve E y = c on the replicated coarse problem.

    direct: one small matmul with the prefactorized inverse. iterative:
    the nested solve dispatches through the *same Krylov stack as the
    fine level* (level_2_krylov_method: cg | gmres), preconditioned per
    level_2_schwarz_method (block-Jacobi / overlapping neighbor-block
    RAS/ASM / none) plus the level-3 deflated correction — the
    InexactCoarseOperator::solve recursion
    (HPDDM_inexact_coarse_operator.hpp:741-778)."""
    anchor = co.E_inv if co.E_inv is not None else co.E
    cd = c.astype(anchor.dtype)
    if co.mode == "direct":
        return co.E_inv @ cd

    E = co.E
    N_c, mu = cd.shape

    def prec3(r):
        """(N_c, mu) -> (N_c, mu): level-2 smoother + level-3 correction."""
        if co.prec == "none":
            z = r
        elif co.prec in ("ras", "asm"):
            rp = jnp.concatenate(
                [r, jnp.zeros((1, mu), dtype=r.dtype)], axis=0)
            rg = rp[co.loc_idx]                              # (S, L, mu)
            zl = jnp.einsum("sab,sbm->sam", co.Eloc_inv, rg)
            if co.prec == "ras":
                # restricted: each block keeps only its own rows (the
                # leading nu_max of its local problem)
                z = zl[:, : co.nu_max, :].reshape(N_c, mu)
            else:
                S_, L_ = co.loc_idx.shape
                z = jnp.zeros_like(rp)
                z = z.at[co.loc_idx.reshape(-1)].add(
                    zl.reshape(S_ * L_, mu))[:N_c]
        else:                                                # block-Jacobi
            z = co.E_inv @ r
        if co.lvl3 != "none" and co.Z2 is not None:
            z = z + co.Z2 @ _solve_level3(co, co.Z2.T.conj() @ r)
        return z

    from hpddm_tpu.solvers.base import LinearOperator
    op = LinearOperator(gmv=lambda x: (E @ x[0])[None],
                        apply=lambda x: prec3(x[0])[None])
    if co.method == "gmres":
        from hpddm_tpu.solvers.gmres import gmres
        res = gmres(op, cd[None], tol=co.inner_tol, restart=co.restart,
                    max_it=co.inner_max_it)
    else:
        from hpddm_tpu.solvers.cg import cg
        res = cg(op, cd[None], tol=co.inner_tol, max_it=co.inner_max_it)
    if return_its:
        return res.x[0], res.iterations
    return res.x[0]


def _coarse_solve_bsr(co: CoarseState, c: jax.Array,
                      axis_name: Optional[str] = None,
                      return_its: bool = False):
    """Nested Krylov on the *block-sparse* coarse problem.

    c: (S_loc, nu, mu) block RHS. The matvec is E_diag y + sum_j E_nbr[j]
    y_{nbr(j)}; neighbor block vectors are fetched with a one-hot matmul
    over the (all_gathered when sharded) block vector — the distributed
    analogue of InexactCoarseOperator::GMV (bsrmm + halo,
    HPDDM_inexact_coarse_operator.hpp:780-792). The solve dispatches
    through the same Krylov stack as the fine level with the level-2
    options: method (cg | gmres), preconditioner block-Jacobi /
    neighbor-block RAS / none, plus the level-3 aggregate correction."""
    cd = c.astype(co.Eb_diag.dtype)
    S_loc, nu, mu = cd.shape
    active = (jnp.arange(nu)[None, :] < co.nu_loc[:, None])  # (S_loc, nu)
    act = active[:, :, None].astype(cd.dtype)
    cd = cd * act

    def gather_blocks(y):
        yg = y if axis_name is None else jax.lax.all_gather(
            y, axis_name, axis=0, tiled=True)                # (S, nu, mu)
        ypad = jnp.concatenate(
            [yg, jnp.zeros((1, nu, mu), dtype=y.dtype)], axis=0)
        return jnp.einsum("skq,qbm->skbm", co.nbr_oh.astype(y.dtype), ypad)

    def matvec(y):
        yn = gather_blocks(y)                                # (S_loc, K, nu, mu)
        out = (jnp.einsum("sab,sbm->sam", co.Eb_diag, y)
               + jnp.einsum("skab,skbm->sam", co.Eb_nbr, yn))
        return out * act

    def prec(r):
        if co.prec == "none":
            z = r
        elif co.prec in ("ras", "asm") and co.Eloc_inv is not None:
            # one-level block Schwarz with neighbor-block overlap,
            # restricted (RAS): each block keeps its own rows only, so no
            # cross-device scatter is needed (asm maps onto ras here)
            rn = gather_blocks(r)                            # (S, K, nu, mu)
            rloc = jnp.concatenate([r[:, None], rn], axis=1)
            rloc = rloc.reshape(S_loc, -1, mu)               # (S, (K+1)nu, mu)
            zl = jnp.einsum("sab,sbm->sam", co.Eloc_inv, rloc)
            z = zl[:, :nu, :] * act
        else:                                                # block-Jacobi
            z = jnp.einsum("sab,sbm->sam", co.Eb_diag_inv, r) * act
        if co.lvl3 != "none" and co.E2_inv is not None:
            # third level (buildThree): deflation by the level-3 basis —
            # aggregate constants or per-aggregate spectral vectors
            # (level_3_geneo_nu); agg_oh: (S, nu, n3), replicated
            ra = r * act                                     # (S_loc, nu, mu)
            ra_g = ra if axis_name is None else jax.lax.all_gather(
                ra, axis_name, axis=0, tiled=True)           # (S, nu, mu)
            rc3 = jnp.einsum("saq,sam->qm",
                             co.agg_oh.astype(ra_g.dtype), ra_g)
            w3 = _solve_level3(co, rc3)
            w = jnp.einsum("saq,qm->sam",
                           co.agg_oh.astype(w3.dtype), w3)   # (S, nu, mu)
            if axis_name is not None:
                from hpddm_tpu.parallel.ops import axis_index_of
                idx = axis_index_of(axis_name)
                w = jax.lax.dynamic_slice_in_dim(w, idx * S_loc, S_loc, 0)
            z = z + w * act
        return z

    from hpddm_tpu.solvers.base import LinearOperator
    op = LinearOperator(gmv=matvec, apply=prec, axis_name=axis_name)
    if co.method == "gmres":
        from hpddm_tpu.solvers.gmres import gmres
        res = gmres(op, cd, tol=co.inner_tol, restart=co.restart,
                    max_it=co.inner_max_it)
    else:
        from hpddm_tpu.solvers.cg import cg
        res = cg(op, cd, tol=co.inner_tol, max_it=co.inner_max_it)
    if return_its:
        return res.x, res.iterations
    return res.x


def start(state: SchwarzState, b: jax.Array,
          x0: Optional[jax.Array] = None,
          axis_name: Optional[str] = None) -> jax.Array:
    """Initial guess with Dirichlet rows seeded exactly (Schwarz::start,
    HPDDM_schwarz.hpp:496-514): x_i = b_i / a_ii on detected boundary
    rows (penalty-scale or identity diagonals), then one scaled exchange
    so duplicated copies agree. Identity when no boundary rows exist."""
    x = jnp.zeros_like(b) if x0 is None else x0
    bc = state.bc
    if bc is None:
        return x
    mask = jnp.abs(bc) > HPDDM_EPS
    seed = b / jnp.where(mask, bc, 1.0).astype(b.dtype)[:, :, None]
    x = jnp.where(mask[:, :, None], seed, x)
    return scaled_exchange(state.dec, x, axis_name)


def apply(state: SchwarzState, x: jax.Array,
          axis_name: Optional[str] = None) -> jax.Array:
    """Full preconditioner apply (HPDDM_schwarz.hpp:527-612).

    Two-level branches mirror the reference: the smoother inside a
    deflated/balanced correction always ends with the *scaled* exchange
    (the OS/SORAS variant additionally pre-scales by D before the local
    solve). One deliberate deviation: for the *additive* correction with
    an asm/osm variant the smoother term uses the unscaled exchange
    (sum_s R_s^T A_s^-1 R_s), so M^-1 = sum R^T A_s^-1 R + D Z E^-1 Z^T D
    is genuinely symmetric — the combination the reference documents for
    SPD problems (and which CG needs; the reference instead keeps the
    D-scaled exchange even for ASM and relies on the CG->GMRES fallback,
    HPDDM_CG.hpp:40-42). RAS/SORAS keep the reference's scaled exchange."""
    if state.coarse is None:
        return one_level_apply(state, x, axis_name)
    dec = state.dec
    corr = state.coarse.correction
    if corr == "additive":
        out = deflation(state, x, axis_name)
        work = state.solver.solve(x)
        if state.variant in ("asm", "osm"):
            return out + exchange(dec, work, axis_name)
        return out + scaled_exchange(dec, work, axis_name)
    # deflated / balanced (HPDDM_schwarz.hpp:572-608)
    out = deflation(state, x, axis_name)                     # Z E^-1 Z^T D x
    work = x - gmv(state, out, axis_name)                    # (I - A Z E^-1 Z^T D) x
    if state.variant == "soras":
        work = dec.d[:, :, None] * work
    work = state.solver.solve(work)
    work = scaled_exchange(dec, work, axis_name)             # D A_loc^-1 (...)
    if corr == "balanced":
        tmp = gmv(state, work, axis_name)
        work = work - deflation(state, tmp, axis_name)
    return out + work


def compute_residual(state: SchwarzState, x: jax.Array, f: jax.Array,
                     axis_name: Optional[str] = None, norm: str = "l2"):
    """Independent residual recomputation (HPDDM_schwarz.hpp:761-803).

    Returns (norm_b, norm_r) per RHS, POU-weighted so overlapping dofs are
    counted once; Dirichlet-penalty rows are filtered like the reference.
    """
    dec = state.dec
    x = dec.permute(x)
    f = dec.permute(f)
    r = gmv(state, x, axis_name) - f
    w = dec.d[:, :, None]
    f_eff = jnp.where(jnp.abs(f) > HPDDM_EPS * HPDDM_PEN, f / HPDDM_PEN, f)
    if norm == "l2":
        nr = psum_if(jnp.sum(w * jnp.abs(r) ** 2, axis=(0, 1)), axis_name)
        nb = psum_if(jnp.sum(w * jnp.abs(f_eff) ** 2, axis=(0, 1)), axis_name)
        return jnp.sqrt(nb), jnp.sqrt(nr)
    if norm == "l1":
        nr = psum_if(jnp.sum(w * jnp.abs(r), axis=(0, 1)), axis_name)
        nb = psum_if(jnp.sum(w * jnp.abs(f_eff), axis=(0, 1)), axis_name)
        return nb, nr
    nr = jnp.max(jnp.abs(r), axis=(0, 1))
    nb = jnp.max(jnp.abs(f_eff), axis=(0, 1))
    if axis_name is not None:
        nr = jax.lax.pmax(nr, axis_name)
        nb = jax.lax.pmax(nb, axis_name)
    return nb, nr


# ----------------------------------------------------------------------
# Setup (host side)
# ----------------------------------------------------------------------

class Schwarz:
    """Host-side builder: packs matrices, factorizes, assembles the coarse op.

    Mirrors the setup call stack of examples/schwarz.cpp:90-127
    (Subdomain::initialize -> multiplicityScaling/initialize(d) ->
    [solveGEVP/setVectors -> buildTwo] -> callNumfact).
    """

    def __init__(self, mats: Sequence[MatrixCSR],
                 neighbors: Sequence[Sequence[int]],
                 mappings: Sequence[Sequence[np.ndarray]],
                 d: Optional[Sequence[np.ndarray]] = None,
                 options: Optional[Options] = None,
                 fmt: str = "auto",
                 optimized_mats: Optional[Sequence[MatrixCSR]] = None,
                 renumber: bool = False, prefix: str = ""):
        """optimized_mats: user-supplied local matrices factorized instead
        of the plain restrictions for the ORAS/SORAS/OSM variants (e.g.
        Robin interface conditions for Helmholtz) — the user-matrix branch
        of ``callNumfact`` (HPDDM_schwarz.hpp:337-368).

        renumber=True switches to the interface-first layout whose exchange
        is a contiguous slab (no scatters) — worthwhile for unstructured
        matrices that pack as ELL anyway; stencil matrices keep the caller
        numbering so the DIA fast path survives (a symmetric permutation
        scatters the diagonals)."""
        self.opt = options if options is not None else Options()
        self.prefix = prefix      # per-object option prefix (``setPrefix``)
        n_loc = [m.n for m in mats]
        import numpy as _np
        dec_dt = _np.float64 if not mats else (
            _np.float64 if _np.iscomplexobj(_np.zeros(0, mats[0].dtype))
            else _np.dtype(mats[0].dtype).type)
        self.dec = Decomposition.from_subdomains(neighbors, mappings, n_loc,
                                                 d=d, renumber=renumber,
                                                 dtype=dec_dt)
        self.mats = list(mats)           # original numbering (dump/stats)
        self.neighbors = [list(nb) for nb in neighbors]
        self.mappings = [[np.asarray(m, dtype=np.int64) for m in ms]
                         for ms in mappings]
        self.n_max = self.dec.n_max
        self.A = pack_local_matrices(self._permuted(mats),
                                     n_max=self.n_max, fmt=fmt)
        self._apply_gmv_dtype()
        self.optimized_mats = list(optimized_mats) if optimized_mats else None
        self._deflation_vectors: Optional[List[np.ndarray]] = None
        self._state: Optional[SchwarzState] = None

    def _apply_gmv_dtype(self) -> None:
        """Attach a low-precision value mirror for the SpMM hot path
        (-hpddm_gmv_dtype bfloat16): the value-plane stream is the GMV's
        largest memory traffic at flagship scale; bf16 storage halves it
        while accumulation stays in the vector dtype.
        Setup paths (coarse assembly, factorizations, residuals computed
        host-side) keep reading the full-precision values."""
        from hpddm_tpu.core.formats import BatchedDIA as _DIA
        if not isinstance(self.A, _DIA):
            return
        want = self.opt.val("gmv_dtype")
        if want in (None, "same"):
            return
        import dataclasses as _dc2
        self.A = _dc2.replace(
            self.A, values_lp=self.A.values.astype(jnp.bfloat16))
        self._refresh_canvas_planes()

    def _refresh_canvas_planes(self) -> None:
        """(Re)build the pre-split canvas value planes in the hot dtype.

        In-jit slicing of the packed (S, ndiag, n) buffer can materialize
        per-plane copies every scan step when the operator state is a jit
        *argument* (as all at-scale solve paths pass it)."""
        import dataclasses as _dc3
        from hpddm_tpu.core.formats import BatchedDIA as _DIA
        A = self.A
        if not isinstance(A, _DIA) or A.canvas_hw is None:
            return
        H, W = A.canvas_hw
        vals = A.values_lp if A.values_lp is not None else A.values
        S, k, _ = vals.shape
        vc = vals.reshape(S, k, H, W)
        self.A = _dc3.replace(
            A, values_planes=tuple(vc[:, ki] for ki in range(k)))

    def exchange_matrices(self) -> None:
        """Algebraic matrix-overlap exchange: the matrix variant of
        ``Schwarz::exchange()`` (HPDDM_schwarz.hpp:190-275).

        For every neighbor pair with aligned shared-index lists, the
        sharer whose POU is nonzero on a shared row sends that row's
        entries restricted to the shared columns; receivers *overwrite*
        the values at positions already present in their sparsity (the
        pattern is preserved, exactly like the reference's assignment
        into the existing ja_). This lets overlap blocks of local
        matrices be completed/refreshed from a distributed assembled
        matrix — e.g. non-owner copies built with stale or missing
        values. Senders apply in ascending subdomain id, so the result
        is deterministic (the reference's Waitany order is not).
        Host-side setup; repacks the device operator afterwards."""
        import scipy.sparse as sp
        S = self.dec.S
        # POU in the caller numbering (dec.d is in internal numbering)
        d_int = np.asarray(self.dec.d)
        d = np.zeros_like(d_int)
        if self.dec.renumbered:
            perm = np.asarray(self.dec.perm)
            for s in range(S):
                d[s][perm[s]] = d_int[s]
        else:
            d = d_int
        csrs = [m.scipy(expand=True).tocsr() for m in self.mats]
        out = [c.copy() for c in csrs]
        out_keys = []                  # canonical (row*N + col) per entry
        for c in out:
            c.sort_indices()
            n = c.shape[0]
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(c.indptr))
            out_keys.append(rows * n + c.indices.astype(np.int64))
        for s in range(S):             # ascending sender id: deterministic
            A_s = csrs[s]
            for q, idx_s in zip(self.neighbors[s], self.mappings[s]):
                pos = list(self.neighbors[q]).index(s)
                idx_q = np.asarray(self.mappings[q][pos], dtype=np.int64)
                sendable = d[s][idx_s] > HPDDM_EPS
                if not sendable.any():
                    continue
                m = len(idx_s)
                sub_s = A_s[idx_s][:, idx_s].tocoo()
                keep = sendable[sub_s.row]             # POU-owned rows only
                sr, sc = sub_s.row[keep], sub_s.col[keep]
                sv = sub_s.data[keep]
                # intersect with the receiver's *stored pattern* on the
                # shared block (values irrelevant — explicit zeros count)
                blk_q = csrs[q][idx_q][:, idx_q].tocoo()
                keys_q = np.unique(blk_q.row.astype(np.int64) * m
                                   + blk_q.col)
                key_s = sr.astype(np.int64) * m + sc
                hit = np.isin(key_s, keys_q)
                if not hit.any():
                    continue
                r_glob = idx_q[sr[hit]]
                c_glob = idx_q[sc[hit]]
                # locate each (r, c) inside out[q]'s canonical key array —
                # positions exist by construction (pattern intersected)
                tgt = out[q]
                key = r_glob * tgt.shape[0] + c_glob
                posn = np.searchsorted(out_keys[q], key)
                tgt.data[posn] = sv[hit]
        self.update_matrices([MatrixCSR(m) for m in out])

    def restriction(self) -> bool:
        """Boolean rounding of the partition of unity
        (``Schwarz::restriction``, HPDDM_schwarz.hpp:277-333): every dof
        whose POU is fractional (or whose copies do not sum to 1) is
        assigned to the sharer with the largest value (ties to the
        higher subdomain id) — that copy gets 1, the others 0. Rebuilds
        the decomposition with the rounded POU; returns whether any
        value changed."""
        d_int = np.asarray(self.dec.d)
        d = np.zeros_like(d_int)
        if self.dec.renumbered:
            perm = np.asarray(self.dec.perm)
            for s in range(self.dec.S):
                d[s][perm[s]] = d_int[s]
        else:
            d = d_int.copy()
        d_list = [d[s][: self.mats[s].n].copy()
                  for s in range(self.dec.S)]
        changed = _restrict_pou(self.neighbors, self.mappings, d_list)
        if changed:
            self.dec = Decomposition.from_subdomains(
                self.neighbors, self.mappings,
                [m.n for m in self.mats], d=d_list, scaling="given",
                renumber=self.dec.renumbered, dtype=d_int.dtype)
            self._state = None
        return changed

    def _boundary_conditions(self):
        """(S, n_max) Dirichlet-row diagonal values (0 elsewhere), internal
        numbering; None when no boundary rows exist. Memoized per matrix
        set (a per-subdomain scipy pass; invalidated by update_matrices).

        Row i is a boundary row when its diagonal is penalty-scale
        (>= HPDDM_EPS * HPDDM_PEN — penalty rows keep their off-diagonals
        in the reference too), or when its off-diagonals vanish and the
        diagonal is ~1 (an eliminated identity row). The batched
        re-expression of Subdomain::boundaryCond
        (HPDDM_subdomain.hpp:310-336); host-side, once at setup."""
        cached = getattr(self, "_bc_cache", _BC_UNSET)
        if cached is not _BC_UNSET:
            return cached
        import scipy.sparse as sp
        mats = self._permuted(self.mats)
        bc = np.zeros((self.dec.S, self.n_max),
                      dtype=np.asarray(mats[0].scipy().data).dtype)
        found = False
        for s, m in enumerate(mats):
            csr = m.scipy(expand=True).tocsr()
            n = csr.shape[0]
            diag = np.asarray(csr.diagonal())
            off = csr - sp.diags(diag)
            off_max = np.abs(off).max(axis=1).toarray().ravel()
            pen = np.abs(diag) >= HPDDM_EPS * HPDDM_PEN
            iden = (off_max <= HPDDM_EPS) & (np.abs(diag - 1.0) <= HPDDM_EPS)
            rows = pen | iden
            if rows.any():
                found = True
                bc[s, :n][rows] = diag[rows]
        self._bc_cache = jnp.asarray(bc) if found else None
        return self._bc_cache

    def _permuted(self, mats: Sequence[MatrixCSR]) -> List[MatrixCSR]:
        """Apply the decomposition's interface-first renumbering to local
        matrices (host-side, once at setup)."""
        if not self.dec.renumbered:
            return list(mats)
        out = []
        perm_np = np.asarray(self.dec.perm)
        for s, m in enumerate(mats):
            p = perm_np[s][perm_np[s] < m.n]
            # sparse-safe symmetric permutation (np.ix_ on sparse densifies)
            csr = m.scipy(expand=True)[p, :][:, p]
            out.append(MatrixCSR(csr))
        return out

    # -- HPDDM-style hooks -------------------------------------------------
    def set_vectors(self, vectors: Sequence[np.ndarray]) -> None:
        """User deflation vectors (``setVectors``): vectors[s] is (n_s, nu_s),
        given in the caller's numbering (permuted internally)."""
        vecs = [np.atleast_2d(np.asarray(v)).reshape(self.mats[s].n, -1)
                for s, v in enumerate(vectors)]
        self._deflation_vectors = [self.dec.permute_host(v, s)
                                   for s, v in enumerate(vecs)]

    def solve_gevp(self, neumann: Sequence[MatrixCSR],
                   nu=None, method: str = "auto") -> np.ndarray:
        """GenEO: local pencil A_neu v = lambda (DAD|overlap) v
        (``Schwarz::solveGEVP``, HPDDM_schwarz.hpp:665-715). Smallest-lambda
        eigenvectors become the deflation vectors; returns nu per subdomain.

        nu: scalar or (S,) requested counts; defaults to -hpddm_geneo_nu.
        Threshold / force-uniformity honor -hpddm_geneo_threshold and
        -hpddm_geneo_force_uniformity.

        ``neumann`` must be genuine (unassembled/Neumann) SPSD local
        matrices — like the reference, which requires an auxiliary matrix
        for GenEO (PCHPDDMSetAuxiliaryMat): feeding the assembled
        restrictions here yields an indefinite pencil and a corrupted
        coarse space.
        """
        from hpddm_tpu.precond.geneo import (scale_into_overlap,
                                             solve_gevp_dense, select_nu)
        opt = self.opt
        pfx = getattr(self, "prefix", "")
        S = self.dec.S
        if nu is None:
            nu = int(opt.val("geneo_nu", prefix=pfx))
        nu_req = np.full(S, nu, dtype=np.int64) if np.isscalar(nu) \
            else np.asarray(nu, dtype=np.int64)
        nu_max_req = int(max(1, nu_req.max()))
        # -hpddm_geneo_estimate_nu (HPDDM_schwarz.hpp:686-703): size the
        # eigensolve by the number of pencil eigenvalues below the
        # threshold (the reference's factorization-inertia estimate; the
        # dense path computes the full spectrum, so the count is exact)
        threshold_opt = opt.val("geneo_threshold", prefix=pfx)
        estimate = int(opt.val("geneo_estimate_nu", prefix=pfx) or 0)
        if estimate and threshold_opt is not None:
            cap = estimate if estimate > 1 else max(4 * nu_max_req, 16)
            nu_max_req = int(min(self.n_max, max(nu_max_req, cap)))

        if method == "auto":
            method = "lanczos" if (self.n_max > 6000 or
                                   opt.val("local_solver", prefix=pfx)
                                   in ("fft", "dst_cheby", "banded")) \
                else "dense"
        if method == "lanczos":
            lam, V = self._solve_gevp_lanczos(neumann, nu_max_req)
        else:
            A_neu = batched_dense_from(pack_local_matrices(
                self._permuted(neumann), n_max=self.n_max, fmt="dense",
                pad_identity=True))
            B = scale_into_overlap(self.A, self.dec)
            lam, V = solve_gevp_dense(A_neu, B, nu_max_req)
        lam_np = np.array(lam)
        V_np = np.array(V)  # writable: force-uniformity may pad columns
        threshold = opt.val("geneo_threshold", prefix=pfx)
        if estimate and threshold is not None:
            est_counts = np.clip((lam_np < float(threshold)).sum(axis=1),
                                 1, nu_max_req)
            nu_req = est_counts.astype(np.int64)
            if int(opt.val("verbosity", 0)) > 0:
                print(f"GenEO estimate_nu: {est_counts.tolist()} "
                      f"eigenvalues below {float(threshold):g}")
        nu_loc, V_np = select_nu(
            lam_np, nu_req,
            threshold=float(threshold) if threshold is not None else None,
            force_uniformity=opt.val("geneo_force_uniformity", prefix=pfx),
            rng=np.random.default_rng(42), vectors=V_np)
        self._deflation_vectors = [
            np.ascontiguousarray(V_np[s, : self.mats[s].n, : int(nu_loc[s])])
            for s in range(S)]
        # HPDDM writes the attained count back into the option map
        self.opt["geneo_nu"] = int(nu_loc.max(initial=1))
        dump = opt.val("dump_eigenvectors")
        if dump:
            # Eigensolver::dump analogue: eigenvalues + vectors, text
            for s in range(S):
                with open(f"{dump}_{s}.txt", "w") as fh:
                    fh.write("# GenEO eigenpairs (lambda then vector "
                             "columns)\n")
                    fh.write(" ".join(f"{v:.15e}"
                                      for v in lam_np[s, : int(nu_loc[s])])
                             + "\n")
                    np.savetxt(fh, V_np[s, : self.mats[s].n,
                                        : int(nu_loc[s])])
        return nu_loc

    def _solve_gevp_lanczos(self, neumann: Sequence[MatrixCSR],
                            nu_max_req: int):
        """Matrix-free GenEO for large subdomains: shift-invert Lanczos on
        A_neu^-1 B with inner-CG applies of A_neu^-1 preconditioned by the
        configured local solver (the ARPACK reverse-communication loop of
        HPDDM_ARPACK.hpp:113-148, batched over subdomains)."""
        import jax
        from hpddm_tpu.precond.geneo import solve_gevp_lanczos
        from hpddm_tpu.ops.spmv import spmm
        import os as _os
        import time as _time
        _tprof = _os.environ.get("HPDDM_TPU_TIME_SETUP") == "1"
        _t0 = _time.perf_counter()

        def _mark(what):
            nonlocal _t0
            if _tprof:
                t = _time.perf_counter()
                print(f"[setup] {what}: {t - _t0:.1f}s", flush=True)
                _t0 = t
        dec = self.dec
        A_neu_p = pack_local_matrices(self._permuted(neumann),
                                      n_max=self.n_max, fmt="auto",
                                      pad_identity=True)
        _mark("pack neumann")
        mask = (dec.ov_mask.astype(dec.d.dtype) * dec.d)

        # every operator state crosses the jit boundary through ``aux``:
        # closure-captured arrays are embedded into the HLO as literals
        def apply_B(aux, x):
            A_p, msk = aux[0], aux[1]
            return msk[:, :, None] * spmm(A_p, msk[:, :, None] * x)

        # inner preconditioner: the configured local solver on the
        # *assembled* matrix (spectrally close to the Neumann matrix).
        # banded skips this entirely: it factors the Neumann matrix itself
        opt = self.opt
        kind = opt.val("local_solver", prefix=getattr(self, "prefix", ""))
        prec = None
        if kind == "banded":
            pass
        elif kind in ("fft", "dst_cheby"):
            from hpddm_tpu.ops.fft_solve import build_fft_solver
            boxes, Nx, Ny = self._grid_geometry
            prec = build_fft_solver(boxes, Nx, Ny, self.n_max,
                                    dtype=dec.d.dtype)
        elif kind == "cheby":
            from hpddm_tpu.ops.cheby_solve import JacobiSolver, _extract_dinv
            prec = JacobiSolver(dinv=_extract_dinv(self.A, self.n_max))
        else:
            prec = factorize(batched_dense_from(self.A), kind="inv")

        # diagonal regularization of the (possibly singular) Neumann matrix
        diag_scale = float(np.mean([np.abs(m.scipy().diagonal()).mean()
                                    for m in neumann]))
        eps_reg = 1e-8 * diag_scale

        def apply_Aneu(A_neu, x):
            return spmm(A_neu, x) + eps_reg * x

        if kind == "banded":
            # exact shift-invert: banded factor of the regularized Neumann
            # matrix itself — one solve (+1 refinement) replaces the whole
            # inner CG, which would otherwise pay the sequential scan of
            # the banded sweep 25x per Lanczos step
            import scipy.sparse as sp
            from hpddm_tpu.ops.banded_solve import build_banded_solver

            class _W:
                def __init__(self, A):
                    self._A = A

                def scipy(self, expand=True):
                    return self._A

            regs = [_W(sp.csr_matrix(
                m.scipy(expand=True).astype(np.float64)
                + eps_reg * sp.identity(m.n)))
                for m in self._permuted(neumann)]
            _raw_boxes = self._banded_boxes(required=False)
            lboxes = None if _raw_boxes is None else \
                [(0, i1 - i0, 0, j1 - j0)
                 for (i0, i1, j0, j1) in _raw_boxes]
            # method="host": the regularized Neumann pencil is *nearly
            # singular* (eps_reg ~ 1e-8 x diag), so the trailing Schur
            # blocks cancel catastrophically in f32 — a device-f32
            # recursion perturbs exactly the near-null eigenvalues GenEO
            # must resolve (measured: 57 vs 23 outer its at the 1024^2
            # flagship). The f64 host recursion keeps them; the *smoother*
            # factors (Dirichlet matrices, moderate cond) stay on the
            # device path.
            if lboxes is None:
                from hpddm_tpu.ops.banded_solve import \
                    build_banded_solver_rcm
                Knb, _ = build_banded_solver_rcm(
                    regs, self.n_max, dtype=dec.d.dtype,
                    rows_per_block=int(opt.val("banded_block_rows")),
                    method="host")
            else:
                Knb = build_banded_solver(
                    regs, lboxes, self.n_max, dtype=dec.d.dtype,
                    rows_per_block=int(opt.val("banded_block_rows")),
                    method="host")
            _mark("banded neumann factor (build/cache)")
            if _tprof:
                jax.block_until_ready(Knb.Dinv)
            _mark("banded factor H2D")

            def apply_Ainv(aux, r):
                A_p, msk, A_neu, solver = aux
                x = solver.solve(r)
                return x + solver.solve(r - apply_Aneu(A_neu, x))

            aux = (self.A, mask, A_neu_p, Knb)
        else:
            inner_its = 25

            def apply_Ainv(aux, r):
                # fixed-iteration preconditioned CG (jittable, batched) — a
                # fori_loop so the Lanczos scan body traces one CG step
                A_p, msk, A_neu, solver = aux
                x = jnp.zeros_like(r)
                res = r
                z = solver.solve(res)
                p = z
                rz = jnp.einsum("snm,snm->s", res, z)

                def body(_, carry):
                    x, res, p, rz = carry
                    Ap = apply_Aneu(A_neu, p)
                    pAp = jnp.einsum("snm,snm->s", p, Ap)
                    alpha = rz / jnp.where(jnp.abs(pAp) > 0, pAp, 1.0)
                    x = x + alpha[:, None, None] * p
                    res = res - alpha[:, None, None] * Ap
                    z = solver.solve(res)
                    rz_new = jnp.einsum("snm,snm->s", res, z)
                    beta = rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0)
                    p = z + beta[:, None, None] * p
                    return x, res, p, rz_new

                x, _, _, _ = jax.lax.fori_loop(0, inner_its, body,
                                               (x, res, p, rz))
                return x

            aux = (self.A, mask, A_neu_p, prec)

        ncv = opt.val("lanczos_ncv")
        _mark("operator prep")
        lam, V = solve_gevp_lanczos(
            apply_Ainv, apply_B, dec.S, self.n_max,
            nu_max_req, ncv=int(ncv) if ncv else None,
            dtype=dec.d.dtype, aux=aux)
        _mark("lanczos scan + projected eig")
        return lam, V

    def build(self, dtype=None) -> SchwarzState:
        """Factorize local solvers (+ coarse operator) and return the state
        (``callNumfact``, HPDDM_schwarz.hpp:337-368)."""
        opt = self.opt
        pfx = getattr(self, "prefix", "")
        variant = opt.val("schwarz_method", prefix=pfx)
        local_kind = opt.val("local_solver", prefix=pfx)
        reuse = self._state is not None and int(opt.val(
            "reuse_preconditioner", 0))
        if reuse:
            # -hpddm_reuse_preconditioner: keep the existing factorization
            # and coarse operator (HPDDM_schwarz.hpp:364-366)
            state = dataclasses.replace(self._state, A=self.A,
                                        variant=variant)
            self._state = state
            return state
        if local_kind == "fft":
            # DST-based fast Poisson local solver (grid geometry required;
            # set via set_grid_geometry). O(n log n) applies, no factors.
            from hpddm_tpu.ops.fft_solve import build_fft_solver
            geo = getattr(self, "_grid_geometry", None)
            if geo is None:
                raise ValueError("local_solver=fft requires "
                                 "set_grid_geometry(boxes, Nx, Ny)")
            boxes, Nx, Ny = geo
            dt = dtype if dtype is not None else self.A.values.dtype
            solver = build_fft_solver(boxes, Nx, Ny, self.n_max, dtype=dt)
            coarse = None
            correction = opt.val("schwarz_coarse_correction", prefix=pfx)
            if correction is not None:
                coarse = self._build_coarse(correction, jnp.dtype(dt))
            state = SchwarzState(dec=self.dec, A=self.A, solver=solver,
                                 coarse=coarse, variant=variant,
                                 bc=self._boundary_conditions())
            self._state = state
            return state
        if local_kind == "banded":
            # exact block-tridiagonal LU for grid subdomains
            # (ops/banded_solve.py): O(n*wx) factor memory — exact local
            # solves far beyond the dense O(n^2) cap, heterogeneous-exact
            # where the DST solver is only spectrally close
            from hpddm_tpu.ops.banded_solve import (build_banded_solver,
                                                    build_banded_solver_rcm)
            lboxes = self._banded_boxes(required=False)
            if lboxes is not None and self.dec.renumbered:
                raise ValueError("local_solver=banded with grid geometry "
                                 "requires the grid-ordered "
                                 "(non-renumbered) layout")
            dt = dtype if dtype is not None else self.A.values.dtype
            src = self.mats
            if self.optimized_mats is not None and \
                    variant in ("oras", "soras", "osm"):
                src = self.optimized_mats
            import os as _os
            import time as _time
            _tprof = _os.environ.get("HPDDM_TPU_TIME_SETUP") == "1"
            _t0 = _time.perf_counter()
            if lboxes is None:
                # unstructured matrices: per-subdomain RCM banded factors
                # (the permutation rides the solver's slot gathers, so the
                # interface-first renumbered layout composes freely)
                solver, _bws = build_banded_solver_rcm(
                    self._permuted(src), self.n_max, dtype=dt,
                    rows_per_block=int(opt.val("banded_block_rows",
                                               prefix=pfx)))
                if _tprof:
                    print(f"[build] rcm bandwidths: max={max(_bws)}",
                          flush=True)
            else:
                solver = build_banded_solver(
                    src, lboxes, self.n_max, dtype=dt,
                    rows_per_block=int(opt.val("banded_block_rows",
                                               prefix=pfx)))
            if _tprof:
                jax.block_until_ready(solver.Dinv)
                print(f"[build] banded factor: "
                      f"{_time.perf_counter() - _t0:.1f}s", flush=True)
                _t0 = _time.perf_counter()
            coarse = None
            correction = opt.val("schwarz_coarse_correction", prefix=pfx)
            if correction is not None:
                coarse = self._build_coarse(correction, jnp.dtype(dt))
            if _tprof:
                jax.tree_util.tree_map(
                    lambda x: jax.block_until_ready(x)
                    if hasattr(x, "block_until_ready") else x, coarse)
                print(f"[build] coarse: "
                      f"{_time.perf_counter() - _t0:.1f}s", flush=True)
            state = SchwarzState(dec=self.dec, A=self.A, solver=solver,
                                 coarse=coarse, variant=variant,
                                 bc=self._boundary_conditions())
            self._state = state
            return state
        if local_kind in ("cheby", "dst_cheby"):
            # inexact k-step Chebyshev local solves (ops/cheby_solve.py):
            # zero factor memory; the answer to large heterogeneous
            # subdomains that no batched dense factor (O(n^2) memory) or
            # constant-coefficient DST solve covers exactly
            from hpddm_tpu.ops.cheby_solve import build_cheby_solver
            dt = dtype if dtype is not None else self.A.values.dtype
            inner = None
            if local_kind == "dst_cheby":
                from hpddm_tpu.ops.fft_solve import build_fft_solver
                geo = getattr(self, "_grid_geometry", None)
                if geo is None:
                    raise ValueError("local_solver=dst_cheby requires "
                                     "set_grid_geometry(boxes, Nx, Ny)")
                boxes, Nx, Ny = geo
                inner = build_fft_solver(boxes, Nx, Ny, self.n_max, dtype=dt)
            if self.optimized_mats is not None and \
                    variant in ("oras", "soras", "osm"):
                A_it = pack_local_matrices(
                    self._permuted(self.optimized_mats), n_max=self.n_max,
                    fmt="auto", pad_identity=True)
            else:
                A_it = self.A
            solver = build_cheby_solver(
                A_it.astype(dt), self.dec.row_mask, inner=inner,
                k=int(opt.val("local_cheby_steps", prefix=pfx)),
                power_its=int(opt.val("local_cheby_power_its", prefix=pfx)))
            coarse = None
            correction = opt.val("schwarz_coarse_correction", prefix=pfx)
            if correction is not None:
                coarse = self._build_coarse(correction, jnp.dtype(dt))
            state = SchwarzState(dec=self.dec, A=self.A, solver=solver,
                                 coarse=coarse, variant=variant,
                                 bc=self._boundary_conditions())
            self._state = state
            return state
        if self.optimized_mats is not None and \
                variant in ("oras", "soras", "osm"):
            A_fact = batched_dense_from(pack_local_matrices(
                self._permuted(self.optimized_mats), n_max=self.n_max,
                fmt="dense"))
        else:
            A_fact = batched_dense_from(self.A)
        if dtype is not None:
            A_fact = A_fact.astype(dtype)
        solver = factorize(A_fact, kind=local_kind)

        coarse = None
        correction = opt.val("schwarz_coarse_correction", prefix=pfx)
        if correction is not None:
            coarse = self._build_coarse(correction, A_fact.dtype)

        state = SchwarzState(dec=self.dec, A=self.A, solver=solver,
                             coarse=coarse, variant=variant,
                             bc=self._boundary_conditions())
        self._state = state
        dump = opt.val("dump_matrices")
        if dump:
            # one file per subdomain, reference text format
            for s, m in enumerate(self.mats):
                m.dump(f"{dump}_{s}.txt")
        return state

    def exchange_rhs(self, f):
        """Make a (possibly inconsistent) RHS consistent, in the caller's
        numbering (the driver's ``A.exchange<true>(f, mu)``)."""
        fp = self.dec.permute(jnp.asarray(f))
        return self.dec.unpermute(scaled_exchange(self.dec, fp))

    def set_banded_shapes(self, shapes) -> None:
        """Declare the block-tridiagonal structure of the local matrices
        for -hpddm_local_solver banded when the 2D grid geometry does not
        apply: ``shapes[s] = (rows, cols)`` with local index =
        row*cols + col and inter-row coupling diagonal. For 3D boxes
        (models/diffusion3d: plane-major local ordering) pass
        rows = wz and cols = wx*wy — the 7-point plane-to-plane coupling
        is diagonal, so the plane-blocked LU applies unchanged (factor
        memory (S, wz, (wx*wy)^2): practical up to ~32^3 locals)."""
        self._banded_shapes = [(int(r), int(c)) for (r, c) in shapes]

    def _banded_boxes(self, required: bool = True):
        """(0, cols, 0, rows) boxes for build_banded_solver, from
        set_banded_shapes or the 2D grid geometry; None (when not
        ``required``) selects the RCM fallback for unstructured matrices
        (ops/banded_solve.build_banded_solver_rcm)."""
        shapes = getattr(self, "_banded_shapes", None)
        if shapes is not None:
            return [(0, c, 0, r) for (r, c) in shapes]
        geo = getattr(self, "_grid_geometry", None)
        if geo is None:
            if required:
                raise ValueError("local_solver=banded requires "
                                 "set_grid_geometry(boxes, Nx, Ny) or "
                                 "set_banded_shapes(shapes)")
            return None
        return geo[0]

    def set_grid_geometry(self, boxes, Nx: int, Ny: int) -> None:
        """Attach grid geometry (the generator's subdomain boxes) enabling
        -hpddm_local_solver fft; for uniform-box decompositions
        (models/diffusion2d.generate_uniform) this also switches
        ``exchange`` to the scatter-free slab halo path (parallel/grid.py).
        """
        self._grid_geometry = (list(boxes), int(Nx), int(Ny))
        if not self.dec.renumbered:
            import dataclasses as _dc
            from hpddm_tpu.parallel.grid import build_grid_plan
            plan = build_grid_plan(boxes)
            if plan is not None and plan.H * plan.W == self.dec.n_max:
                self.dec = _dc.replace(self.dec, grid=plan)
        self._try_canvas_annotate()

    def _try_canvas_annotate(self) -> None:
        """Switch the packed DIA matrix to the 2-D canvas SpMM when the
        decomposition is a uniform grid and the values are seam-safe.

        The canvas form reads zero padding where the flat DIA form reads
        across a canvas row seam (flat offset +-1 at a row end), so it is
        only valid when every E/W coupling vanishes there — true for grid
        stencils, checked explicitly here (ops/spmv.py spmm_dia_canvas)."""
        import dataclasses as _dc
        from hpddm_tpu.core.formats import BatchedDIA
        from hpddm_tpu.ops.spmv import dia_canvas_moves
        geo = getattr(self, "_grid_geometry", None)
        if geo is None or self.dec.renumbered or \
                not isinstance(self.A, BatchedDIA) or \
                self.A.canvas_hw is not None:
            return
        boxes = geo[0]
        hw = {(j1 - j0, i1 - i0) for (i0, i1, j0, j1) in boxes}
        if len(hw) != 1:
            return                      # nonuniform boxes: keep flat
        (H, W) = next(iter(hw))
        if H * W != self.n_max or \
                any(m.n != self.n_max for m in self.mats):
            return
        moves = dia_canvas_moves(self.A.offsets, W)
        if moves is None:
            return
        if W < 2:
            return
        # seam check on the host CSR copies (no device-to-host copy of
        # the packed values; the CSR scan is milliseconds). Every offset
        # whose canvas move shifts columns (dj != 0) must vanish where the
        # move leaves the canvas row — incl. quirk offsets like the
        # reference generator's +-(W-1) vertical stride, which decompose
        # to diagonal (+-1, -+1) moves.
        for m in self.mats:
            c = m.scipy(expand=True).tocoo()
            off = c.col - c.row
            colpos = c.row % W
            for o, (_, dj) in zip(self.A.offsets, moves):
                if dj == 0:
                    continue
                edge = (colpos == W - 1) if dj == 1 else (colpos == 0)
                if np.any((off == o) & edge & (c.data != 0)):
                    return              # seam coupling present: not a grid
        self.A = _dc.replace(self.A, canvas_hw=(H, W),
                             canvas_sym=self._canvas_symmetry(moves))
        self._refresh_canvas_planes()

    def _canvas_symmetry(self, moves):
        """Transpose-plane map for the canvas SpMM (None when unusable).

        When every local matrix is *exactly* symmetric (A == A^T bitwise,
        checked on the host CSR copies), each negative-move plane's values
        are the shifted positive-move plane: V_-m[p] = V_+m[p - m]. The
        SpMM then skips the HBM stream of the redundant planes (5-point:
        5 -> 3 planes) with bitwise-identical results.

        Default OFF (HPDDM_TPU_CANVAS_SYM=1 enables): the saved value
        reads trade against extra shift-of-product temporaries; not
        measured on the GPU (ROADMAP D2)."""
        import os
        if os.environ.get("HPDDM_TPU_CANVAS_SYM", "0") != "1":
            return None
        for m in self.mats:
            c = m.scipy(expand=True).tocsr()
            dlt = (c - c.T).tocoo()
            if dlt.nnz and np.any(dlt.data != 0):
                return None
        from hpddm_tpu.ops.spmv import dia_canvas_moves
        by_move = {mv: ki for ki, mv in enumerate(moves)}
        sym = [None] * len(moves)
        for ki, (di, dj) in enumerate(moves):
            if (di, dj) >= (0, 0):
                continue                # keep positive-move planes
            partner = by_move.get((-di, -dj))
            if partner is not None and sym[partner] is None:
                sym[ki] = partner
        if not any(s is not None for s in sym):
            return None
        return tuple(sym)

    def operator_state(self) -> SchwarzState:
        """State without any factorization: supports gmv/compute_residual
        only (for SpMV benchmarking and matrix-free pipelines)."""
        return SchwarzState(dec=self.dec, A=self.A, solver=None,
                            coarse=None, variant="none")

    def update_matrices(self, mats: Sequence[MatrixCSR], fmt: str = "auto"):
        """Replace the local matrices for a subsequent solve (combined with
        -hpddm_reuse_preconditioner=1 this skips refactorization)."""
        self.mats = list(mats)
        self.A = pack_local_matrices(self._permuted(mats),
                                     n_max=self.n_max, fmt=fmt)
        self._herm_all = None           # matrix-content caches invalidated
        self._bc_cache = _BC_UNSET
        self._try_canvas_annotate()     # revalidates against the new values
        self._apply_gmv_dtype()

    def statistics(self) -> str:
        """Global decomposition statistics (Subdomain::statistics,
        HPDDM_subdomain.hpp:405-454)."""
        import numpy as _np
        n_loc = _np.asarray(self.dec.n_loc)
        d = _np.asarray(self.dec.d)
        nnz = _np.array([m.nnz for m in self.mats])
        nbrs = _np.asarray(self.dec.if_mask).sum(axis=1)
        owned = (d > 1e-12).sum(axis=1)
        lines = [
            f" --- {self.dec.S} subdomains, global unknowns "
            f"(unique) = {self.dec.n_global}",
            f"     local dofs: min {n_loc.min()} / avg "
            f"{n_loc.mean():.1f} / max {n_loc.max()}",
            f"     local nnz:  min {nnz.min()} / avg {nnz.mean():.1f} "
            f"/ max {nnz.max()}",
            f"     interface dofs per subdomain: min {nbrs.min()} / max "
            f"{nbrs.max()}",
            f"     owned (POU > 0) dofs: min {owned.min()} / max "
            f"{owned.max()}",
        ]
        return "\n".join(lines)

    # -- coarse operator ---------------------------------------------------
    def _coarse_cfg(self) -> dict:
        """Resolve the level-2 / level-3 option set for inexact coarse
        solves (the per-level options of HPDDM_inexact_coarse_operator).

        level_2_krylov_method: cg (default; the coarse E is SPD for SPD
        problems) | gmres. level_2_schwarz_method: ras/oras/soras ->
        neighbor-block RAS, asm/osm -> ASM, none -> identity; unset ->
        block-Jacobi (RAS with zero overlap). level_3_krylov_method:
        unset -> prefactorized direct level-3 solve, none -> no third
        level, cg/gmres -> nested Jacobi-CG with level_3_{tol,max_it}.
        level_3_aggregate_size: coarse blocks per level-3 aggregate."""
        lvl = self.opt.level(2)
        sm = lvl.val("schwarz_method") if "schwarz_method" in lvl else None
        prec = {"ras": "ras", "oras": "ras", "soras": "ras",
                "asm": "asm", "osm": "osm", "none": "none"}.get(sm, "bj")
        if prec == "osm":
            prec = "asm"
        if "krylov_method" in lvl:
            method = lvl.val("krylov_method")
        else:
            # RAS is nonsymmetric — CG stalls on it; pair it with GMRES
            # like the fine-level nonsymmetric fallback (krylov.py)
            method = "gmres" if prec == "ras" else "cg"
        l3 = self.opt.level(3)
        l3m = l3.val("krylov_method") if "krylov_method" in l3 else None
        lvl3 = ("none" if l3m == "none" else
                "cg" if l3m is not None else "direct")
        return dict(method=method, prec=prec,
                    restart=int(lvl.val("gmres_restart", 30)),
                    inner_tol=float(lvl.val("tol", 1e-2)),
                    inner_max_it=int(lvl.val("max_it", 50)),
                    lvl3=lvl3, l3_tol=float(l3.val("tol", 1e-2)),
                    l3_max_it=int(l3.val("max_it", 20)),
                    agg=max(1, int(l3.val("aggregate_size", 1))),
                    l3_nu=int(l3.val("geneo_nu", 0) or 0))

    def _build_chain(self, E2_np, dtype):
        """Levels 4+ of the coarse recursion (round 4, VERDICT r3 #8).

        Generalizes the hardwired buildThree: for every configured
        ``level_k_*`` prefix (k = 4, 5, ..., the reference regex
        ``level_[2-9]\\d*_``, HPDDM_option_impl.hpp:27), aggregate the
        previous level's matrix in groups of ``level_k_aggregate_size``
        indices — constants per aggregate, or the ``level_k_geneo_nu``
        smallest eigenpairs of each aggregate's diagonal block (the GenEO
        rule recursed) — and Galerkin-project. ``level_k_krylov_method``
        cg/gmres continues the chain (Jacobi-CG deflated by level k+1);
        unset/direct prefactorizes and ends it. Returns the CoarseState
        chain_* tuples (empty when no level-4 options are set)."""
        hd = (np.complex128 if np.iscomplexobj(E2_np) else np.float64)
        E_prev = np.asarray(E2_np, dtype=hd)
        chain_Z, chain_E, chain_inv = [], [], []
        modes, tols, max_its = [], [], []
        k = 4
        while True:
            lv = self.opt.level(k)
            requested = any(key in lv for key in
                            ("krylov_method", "aggregate_size", "geneo_nu",
                             "tol", "max_it"))
            if not requested:
                break
            n_prev = E_prev.shape[0]
            agg = max(1, int(lv.val("aggregate_size", 4)))
            q = int(lv.val("geneo_nu", 0) or 0)
            n_agg = (n_prev + agg - 1) // agg
            if q > 0:
                cols = []
                for g in range(n_agg):
                    rows = np.arange(g * agg, min((g + 1) * agg, n_prev))
                    Eg = E_prev[np.ix_(rows, rows)]
                    Eg = 0.5 * (Eg + Eg.conj().T)
                    _, v = np.linalg.eigh(Eg)
                    kk = min(q, len(rows))
                    blk = np.zeros((n_prev, kk), dtype=hd)
                    blk[rows, :] = v[:, :kk]
                    cols.append(blk)
                Zk = np.concatenate(cols, axis=1)
            else:
                Zk = np.zeros((n_prev, n_agg), dtype=hd)
                Zk[np.arange(n_prev), np.arange(n_prev) // agg] = 1.0
            Ek = Zk.conj().T @ (E_prev @ Zk)
            nk = Ek.shape[0]
            Ek = Ek + (1e-12 * np.trace(Ek).real / max(nk, 1)
                       * np.eye(nk, dtype=hd))
            km = lv.val("krylov_method") if "krylov_method" in lv else None
            mode = "cg" if km in ("cg", "gmres") else "direct"
            if mode == "cg":
                inv = np.diag(1.0 / np.diag(Ek))
            else:
                inv = np.linalg.inv(Ek)
            chain_Z.append(jnp.asarray(Zk, dtype=dtype))
            chain_E.append(jnp.asarray(Ek, dtype=dtype))
            chain_inv.append(jnp.asarray(inv, dtype=dtype))
            modes.append(mode)
            tols.append(float(lv.val("tol", 1e-2)))
            max_its.append(int(lv.val("max_it", 20)))
            if mode == "direct":
                break
            E_prev = Ek
            k += 1
        return dict(chain_Z=tuple(chain_Z), chain_E=tuple(chain_E),
                    chain_inv=tuple(chain_inv), chain_modes=tuple(modes),
                    chain_tols=tuple(tols), chain_max_its=tuple(max_its))

    def _nbr_blocks(self):
        """Neighbor subdomain lists from the partner tables (the coarse
        block sparsity: E_sq != 0 only for subdomains sharing dofs)."""
        part = np.asarray(self.dec.partners)
        psub = part // self.dec.m_max
        S = self.dec.S
        return [sorted(set(psub[s][psub[s] < S].tolist())) for s in range(S)]

    @staticmethod
    def _aggregate_ind(S: int, agg: int) -> np.ndarray:
        """(S, n3) aggregate indicator: blocks s // agg share a column."""
        n3 = (S + agg - 1) // agg
        ind = np.zeros((S, n3))
        ind[np.arange(S), np.arange(S) // agg] = 1.0
        return ind

    @staticmethod
    def _lvl3_spectral_basis(Ed_np, En_np, nbr_sub, act, agg: int,
                             q3: int) -> np.ndarray:
        """Per-aggregate spectral level-3 basis (S, nu, n_agg*q).

        For every aggregate g = {s : s // agg == g}, assemble its local
        coarse operator E_g (diagonal + intra-aggregate neighbor blocks,
        restricted to active slots), symmetrize, and take the q smallest
        eigenpairs — the aggregate-local near-kernel the third level must
        carry, exactly the GenEO selection rule one level down
        (HPDDM_schwarz.hpp:449-495 recursed on E). Columns of different
        aggregates have disjoint support."""
        S, nu = Ed_np.shape[0], Ed_np.shape[1]
        n_agg = (S + agg - 1) // agg
        blocks_of = [[] for _ in range(n_agg)]
        for s in range(S):
            blocks_of[s // agg].append(s)
        cols = []
        for g in range(n_agg):
            slots = [(s, a) for s in blocks_of[g]
                     for a in range(nu) if act[s][a]]
            dim = len(slots)
            if dim == 0:
                continue
            index = {sa: i for i, sa in enumerate(slots)}
            Eg = np.zeros((dim, dim), dtype=Ed_np.dtype)
            for s in blocks_of[g]:
                aa = [a for a in range(nu) if act[s][a]]
                ia = [index[(s, a)] for a in aa]
                Eg[np.ix_(ia, ia)] = Ed_np[s][np.ix_(aa, aa)]
                for j, q in enumerate(nbr_sub[s]):
                    q = int(q)
                    if q < S and q // agg == g:
                        bb = [b for b in range(nu) if act[q][b]]
                        iq = [index[(q, b)] for b in bb]
                        Eg[np.ix_(ia, iq)] += En_np[s, j][np.ix_(aa, bb)]
            Eg = 0.5 * (Eg + Eg.conj().T)
            w, v = np.linalg.eigh(Eg)
            k = min(q3, dim)
            blk = np.zeros((S, nu, k), dtype=Ed_np.dtype)
            for i, (s, a) in enumerate(slots):
                blk[s, a, :] = v[i, :k]
            cols.append(blk)
        return np.concatenate(cols, axis=2)

    def _build_coarse(self, correction: str, dtype) -> CoarseState:
        """Assemble E = Z^T A Z and invert it (replicated coarse solve).

        Z columns: user vectors (set_vectors) or GenEO eigenvectors
        (solve_gevp, precond/geneo.py); defaults to the constant vector
        (the nu == 0 branch of examples/schwarz.cpp:116-121).
        """
        dec = self.dec
        S = dec.S
        if self._deflation_vectors is None:
            vecs = [np.ones((self.mats[s].n, 1)) for s in range(S)]
        else:
            vecs = self._deflation_vectors
        nu_loc = np.array([v.shape[1] for v in vecs], dtype=np.int32)
        nu_max = int(nu_loc.max(initial=1))
        Z = np.zeros((S, self.n_max, nu_max), dtype=np.asarray(vecs[0]).dtype)
        for s, v in enumerate(vecs):
            Z[s, : v.shape[0], : v.shape[1]] = v
        Z = jnp.asarray(Z, dtype=dtype)

        assembly = self.opt.val("coarse_assembly") or "dense"
        if assembly != "bsr":
            # the dense Galerkin assembly materializes an (S, n, S*nu)
            # tensor — O(S^2) memory. Auto-switch to the O(S*neighbors)
            # block-sparse path when it would cross ~2 GB (S=64 at 66k
            # dofs is ~17 GB dense); an explicit coarse_assembly=dense
            # request is honored with a warning instead.
            bytes_dense = (S * self.n_max * S * nu_max
                           * jnp.zeros(0, dtype).dtype.itemsize)
            if bytes_dense > _DENSE_COARSE_BYTES_CAP:
                if self.opt.set("coarse_assembly"):
                    print(f"WARNING -- coarse_assembly=dense materializes "
                          f"{bytes_dense / (1 << 30):.1f} GB "
                          f"(S={S}, nu={nu_max}); consider bsr")
                else:
                    if int(self.opt.val("verbosity", 0)) >= 1:
                        print(f"coarse assembly auto-switched to bsr "
                              f"(dense would take "
                              f"{bytes_dense / (1 << 30):.1f} GB)")
                    return self._build_coarse_bsr(correction, dtype, Z,
                                                  nu_loc, nu_max)
        else:
            return self._build_coarse_bsr(correction, dtype, Z, nu_loc,
                                          nu_max)
        E = self._assemble_E(Z, nu_loc, nu_max, dtype)
        lvl = self.opt.level(2)
        dump = lvl.val("dump_matrix")
        if dump:
            # -hpddm_level_2_dump_matrix: reference text dump of E
            import scipy.sparse as _sp
            MatrixCSR(_sp.csr_matrix(np.asarray(E))).dump(str(dump))
        def _inv(M):
            # E is tiny; invert in host f64 for sub-f64 dtypes
            if M.dtype in (jnp.float32.dtype, jnp.bfloat16.dtype):
                return jnp.asarray(
                    np.linalg.inv(np.asarray(M, dtype=np.float64)),
                    dtype=M.dtype)
            return jnp.linalg.inv(M)

        if "krylov_method" in lvl or self.opt.set("level_2_tol"):
            # inexact coarse solves: nested Krylov with level-2 options,
            # dispatched through the same solver stack as the fine level
            N_c = E.shape[0]
            S = self.dec.S
            cfg = self._coarse_cfg()
            blocks = E.reshape(S, nu_max, S, nu_max)
            diag_blocks = jnp.stack([blocks[s, :, s, :] for s in range(S)])
            binv = _inv(diag_blocks)
            Minv = jax.scipy.linalg.block_diag(
                *[binv[s] for s in range(S)])
            # overlapping neighbor-block Schwarz (level_2_schwarz_method)
            Eloc_inv = loc_idx = None
            if cfg["prec"] in ("ras", "asm"):
                hd = (np.complex128 if np.iscomplexobj(np.asarray(E))
                      else np.float64)
                E_np = np.asarray(E, dtype=hd)
                nbrs = self._nbr_blocks()
                Kl = max((len(nb) for nb in nbrs), default=0)
                L = (1 + Kl) * nu_max
                li = np.full((S, L), N_c, dtype=np.int32)
                El = np.tile(np.eye(L, dtype=hd), (S, 1, 1))
                for s in range(S):
                    rows = np.concatenate(
                        [q * nu_max + np.arange(nu_max)
                         for q in [s] + nbrs[s]])
                    li[s, : len(rows)] = rows
                    El[s, : len(rows), : len(rows)] = E_np[np.ix_(rows,
                                                                  rows)]
                Eloc_inv = jnp.asarray(np.linalg.inv(El), dtype=E.dtype)
                loc_idx = jnp.asarray(li)
            # third level (buildThree): constant-per-aggregate deflation
            # of E, or spectral vectors when level_3_geneo_nu is set
            # (smallest eigenpairs of each aggregate's diagonal sub-block
            # of E — the same recursion as the bsr path)
            if cfg["l3_nu"] > 0:
                hd2 = (np.complex128 if np.iscomplexobj(np.asarray(E))
                       else np.float64)
                E_np2 = np.asarray(E, dtype=hd2)
                agg = cfg["agg"]
                cols = []
                for g in range((S + agg - 1) // agg):
                    rows = np.concatenate(
                        [s * nu_max + np.arange(nu_max)
                         for s in range(g * agg, min((g + 1) * agg, S))])
                    Eg = E_np2[np.ix_(rows, rows)]
                    Eg = 0.5 * (Eg + Eg.conj().T)
                    w3_, v3_ = np.linalg.eigh(Eg)
                    kk = min(cfg["l3_nu"], len(rows))
                    blk = np.zeros((N_c, kk), dtype=hd2)
                    blk[rows, :] = v3_[:, :kk]
                    cols.append(blk)
                Z2 = jnp.asarray(np.concatenate(cols, axis=1),
                                 dtype=E.dtype)
            else:
                ind = self._aggregate_ind(S, cfg["agg"])
                Z2 = jnp.asarray(np.repeat(ind, nu_max, axis=0),
                                 dtype=E.dtype)
            n3 = Z2.shape[1]
            E2 = Z2.T.conj() @ (E @ Z2)
            E2 = E2 + (1e-12 * jnp.trace(E2) / n3
                       * jnp.eye(n3, dtype=E.dtype))
            chain = {}
            if cfg["lvl3"] == "cg":
                E2_inv = jnp.diag(1.0 / jnp.diag(E2))        # Jacobi
                E2_keep = E2
                chain = self._build_chain(np.asarray(E2), E.dtype)
            else:
                E2_inv, E2_keep = _inv(E2), None
            return CoarseState(Z=Z, E_inv=Minv, E=E,
                               nu_loc=jnp.asarray(nu_loc), nu_max=nu_max,
                               correction=correction, mode="iterative",
                               inner_tol=cfg["inner_tol"],
                               inner_max_it=cfg["inner_max_it"],
                               method=cfg["method"], restart=cfg["restart"],
                               prec=cfg["prec"], lvl3=cfg["lvl3"],
                               l3_tol=cfg["l3_tol"],
                               l3_max_it=cfg["l3_max_it"],
                               E2_inv=E2_inv, Z2=Z2, E2=E2_keep,
                               Eloc_inv=Eloc_inv, loc_idx=loc_idx,
                               **chain)
        E_inv = _inv(E)
        return CoarseState(Z=Z, E_inv=E_inv, E=None,
                           nu_loc=jnp.asarray(nu_loc), nu_max=nu_max,
                           correction=correction)

    def _build_coarse_bsr(self, correction, dtype, Z, nu_loc,
                          nu_max) -> CoarseState:
        """Neighbor-block-sparse coarse operator (the reference's sparsity
        pattern 's', HPDDM_operator.hpp:378-562, re-designed batched).

        Only diagonal blocks E_ii = (D Z_i)^H A_i (D Z_i) and neighbor
        blocks E_ij = (A_i^H D Z_i)[shared]^H (D Z_j)[shared] are formed —
        the off-diagonal product lives entirely on the interface slab
        (each coarse column is supported on one subdomain, and A_i rows
        are complete wherever d_i != 0, the GMV invariant), so assembly is
        O(S * neighbors) in memory and compute, vs the dense path's
        O(S^2) global-column tensor. The coarse solve is the nested
        block-Jacobi(+3rd level) CG with a block-sparse matvec."""
        dec = self.dec
        S, m_max = dec.S, dec.m_max
        DZ = dec.d[:, :, None] * Z                           # (S, n, nu)
        W = spmm(self.A, DZ)
        E_diag = jnp.einsum("sna,snb->sab", jnp.conj(DZ), W)
        # V = A^H (D Z): for symmetric/Hermitian locals A^H = A and W is
        # already it — skips the host transpose re-pack (15-20 s at the
        # 1M-dof flagship); nonsymmetric matrices pack the conjugate
        # transpose as before
        def _is_herm(m):
            c = m.scipy(expand=True).tocsr()
            d = (c - c.conj().T).tocoo()
            return d.nnz == 0 or not np.any(d.data != 0)

        if getattr(self, "_herm_all", None) is None:
            # ~0.4 s/matrix at flagship nnz: compute once per matrix set
            # (invalidated by update_matrices)
            self._herm_all = all(_is_herm(m) for m in self.mats)
        if self._herm_all:
            V = W.astype(Z.dtype)
        else:
            A_H = pack_local_matrices(
                self._permuted([MatrixCSR(m.scipy().conj().T.tocsr())
                                for m in self.mats]),
                n_max=self.n_max, fmt="auto")
            V = spmm(A_H, DZ.astype(self.A.values.dtype)).astype(Z.dtype)
        gidx = dec.if_idx[:, :, None]
        msk = dec.if_mask[:, :, None]
        Vif = jnp.where(msk, jnp.take_along_axis(V, gidx, axis=1), 0)
        DZif = jnp.where(msk, jnp.take_along_axis(DZ, gidx, axis=1), 0)
        flat = jnp.concatenate(
            [DZif.reshape(S * m_max, nu_max),
             jnp.zeros((1, nu_max), DZif.dtype)], axis=0)
        pvals = flat[dec.partners]                           # (S, m, k, nu)

        # group partner slots by neighbor subdomain (host, setup-only)
        part = np.asarray(dec.partners)
        psub = part // m_max                                 # sentinel -> S
        nbrs = [sorted(set(psub[s][psub[s] < S].tolist())) for s in range(S)]
        K = max([len(nb) for nb in nbrs] + [1])
        nbr_sub = np.full((S, K), S, dtype=np.int64)
        for s, nb in enumerate(nbrs):
            nbr_sub[s, : len(nb)] = nb
        galerkin = self.opt.val("coarse_galerkin") or "multiplication"
        if galerkin == "accumulation":
            # MatrixAccumulation (HPDDM_operator.hpp:563-1021) re-designed
            # batched: each subdomain computes its *partial overlap
            # contribution* G_s = X_s^H (D_s A_s X_s) over the local
            # restrictions X_s of its own and its neighbors' coarse
            # vectors, and E is the additive reduction over subdomains —
            # the Galerkin analogue of the GMV identity
            # sum_s R_s^T D_s A_s R_s = A. Lands exactly on the bsr
            # pattern (a q-r pair contributing through s is necessarily a
            # neighbor pair: their supports intersect).
            ar = jnp.arange(S)[:, None]
            nbr_cols = []
            for j in range(K):
                mask_j = jnp.asarray(psub == nbr_sub[:, j, None, None])
                vals_j = jnp.sum(jnp.where(mask_j[..., None], pvals, 0),
                                 axis=2)                     # (S, m, nu)
                Xq = jnp.zeros((S, self.n_max, nu_max), DZ.dtype)
                Xq = Xq.at[ar, dec.if_idx, :].add(
                    jnp.where(msk, vals_j, 0))
                nbr_cols.append(Xq)
            Xloc = jnp.concatenate([DZ] + nbr_cols, axis=2)
            AX = spmm(self.A, Xloc.astype(self.A.values.dtype)) \
                .astype(Z.dtype)
            G = jnp.einsum("sna,snb->sab", jnp.conj(Xloc),
                           dec.d[:, :, None] * AX)
            G_np = np.asarray(G)                             # host accumulate
            nu = nu_max
            Ed_acc = np.zeros((S, nu, nu), dtype=G_np.dtype)
            En_acc = np.zeros((S, K, nu, nu), dtype=G_np.dtype)
            posn = {}                                        # (s, q) -> col
            for s in range(S):
                posn[(s, s)] = 0
                for j, q in enumerate(nbr_sub[s]):
                    if q < S:
                        posn[(s, int(q))] = j + 1
            rpos = [{int(q): j for j, q in enumerate(nbr_sub[s]) if q < S}
                    for s in range(S)]
            for s in range(S):
                ids = [s] + [int(q) for q in nbr_sub[s] if q < S]
                for a, qa in enumerate(ids):
                    Ga = G_np[s, a * nu:(a + 1) * nu]
                    for b, qb in enumerate(ids):
                        blk = Ga[:, b * nu:(b + 1) * nu]
                        if qa == qb:
                            Ed_acc[qa] += blk
                        elif qb in rpos[qa]:
                            En_acc[qa, rpos[qa][qb]] += blk
            E_diag = jnp.asarray(Ed_acc)
            E_nb = jnp.asarray(En_acc)
        else:
            Vc = jnp.conj(Vif)
            E_nb_parts = []
            for j in range(K):
                mask_j = jnp.asarray(psub == nbr_sub[:, j, None, None])
                E_nb_parts.append(jnp.einsum(
                    "smk,sma,smkb->sab", mask_j.astype(Vif.dtype), Vc,
                    pvals))
            E_nb = jnp.stack(E_nb_parts, axis=1)             # (S, K, nu, nu)

        act = (np.arange(nu_max)[None, :] < np.asarray(nu_loc)[:, None])
        act_j = jnp.asarray(act)
        eye = jnp.eye(nu_max, dtype=E_diag.dtype)
        E_diag = jnp.where(act_j[:, :, None] & act_j[:, None, :],
                           E_diag, eye[None])

        coarse_dtype = self.opt.val("coarse_dtype")
        if coarse_dtype not in (None, "same"):
            E_diag = E_diag.astype(coarse_dtype)
            E_nb = E_nb.astype(coarse_dtype)

        # block-Jacobi inverse in host f64
        hd = (np.complex128 if np.iscomplexobj(np.asarray(E_diag))
              else np.float64)
        Ed_np = np.asarray(E_diag, dtype=hd)
        Eb_diag_inv = jnp.asarray(np.linalg.inv(Ed_np), dtype=E_diag.dtype)

        cfg = self._coarse_cfg()
        En_np = np.asarray(E_nb, dtype=hd)

        lvl = self.opt.level(2)
        if "krylov_method" not in lvl and not self.opt.set("level_2_tol"):
            # No level-2 options: bsr ASSEMBLY (O(S*neighbors), no global-
            # column tensor) + replicated dense DIRECT solve — the
            # reference's default: a direct factorization of the
            # assembled sparse E on the main processes
            # (HPDDM_coarse_operator_impl.hpp:1630). Scatter the blocks
            # into N_c^2 host f64, invert, round (CLAUDE.md invariant:
            # f32 nested coarse solves floor ~1e-5 and can poison the
            # deflated correction; host-f64-then-round does not).
            N_c = S * nu_max
            E_full = np.eye(N_c, dtype=hd)
            for s in range(S):
                sl_s = slice(s * nu_max, (s + 1) * nu_max)
                E_full[sl_s, sl_s] = Ed_np[s]
                for j, q in enumerate(nbr_sub[s]):
                    if q < S:
                        E_full[sl_s, q * nu_max:(q + 1) * nu_max] = \
                            En_np[s, j]
            # rank-revealing inverse: large nu on small subdomains makes
            # the high GenEO modes nearly dependent, and E assembled from
            # f32 products is then numerically singular — a plain inverse
            # blows up (measured at 512^2/S=64/nu=16: |E_inv| 2.5e10,
            # deflated solve diverges to 1e2; rcond 1e-8 still left 7e7
            # and relres 0.4; rcond 1e-5 -> stable 60-it solve). The f32
            # product noise is ~1e-7 relative, amplified through the
            # contrast — truncating below 1e-5*smax drops only
            # noise-dominated directions, and deflation is insensitive to
            # losing near-dependent coarse columns.
            rcond = 1e-5 if np.asarray(E_diag).dtype == np.float32 \
                else 1e-12
            E_inv = jnp.asarray(np.linalg.pinv(E_full, rcond=rcond),
                                dtype=E_diag.dtype)
            return CoarseState(Z=Z, E_inv=E_inv, E=None,
                               nu_loc=jnp.asarray(nu_loc), nu_max=nu_max,
                               correction=correction)

        # overlapping neighbor-block Schwarz (level_2_schwarz_method):
        # local problem of block s = {s} u nbrs(s); blocks between two
        # neighbors of s come from the neighbor's own bsr row (zero when
        # they do not share dofs). Host setup, O(S * K^2) small blocks.
        Eloc_inv = None
        if cfg["prec"] in ("ras", "asm"):
            L = (K + 1) * nu_max
            El = np.tile(np.eye(L, dtype=hd), (S, 1, 1))
            pos = {(s, int(q)): j for s in range(S)
                   for j, q in enumerate(nbr_sub[s]) if q < S}
            for s in range(S):
                ids = [s] + [int(q) for q in nbr_sub[s] if q < S]
                for a, qa in enumerate(ids):
                    for b, qb in enumerate(ids):
                        if qa == qb:
                            blk = Ed_np[qa]
                        elif (qa, qb) in pos:
                            blk = En_np[qa, pos[(qa, qb)]]
                        else:
                            continue
                        El[s, a * nu_max:(a + 1) * nu_max,
                           b * nu_max:(b + 1) * nu_max] = blk
            Eloc_inv = jnp.asarray(np.linalg.inv(El), dtype=E_diag.dtype)

        # third level: deflation of the bsr coarse operator (buildThree).
        # Basis V3 (S, nu, n3): constant per aggregate by default;
        # -hpddm_level_3_geneo_nu q recurses the spectral machinery one
        # level down — the q smallest eigenpairs of each aggregate's
        # local coarse operator (HPDDM_inexact_coarse_operator.hpp:1328)
        if cfg["l3_nu"] > 0:
            V3h = self._lvl3_spectral_basis(Ed_np, En_np, nbr_sub, act,
                                            cfg["agg"], cfg["l3_nu"])
        else:
            ind = self._aggregate_ind(S, cfg["agg"])
            V3h = (ind[:, None, :] * act[:, :, None]).astype(hd)
        n3 = V3h.shape[2]
        # E3 = V3^H E V3 assembled from the bsr blocks (host, small)
        E2 = np.zeros((n3, n3), dtype=hd)
        for s in range(S):
            Vs = V3h[s]                                     # (nu, n3)
            E2 += Vs.conj().T @ (Ed_np[s] * np.outer(act[s], act[s])) @ Vs
            for j, q in enumerate(nbr_sub[s]):
                if q < S:
                    E2 += Vs.conj().T @ En_np[s, j] @ V3h[q]
        E2 += 1e-12 * abs(np.trace(E2)) / n3 * np.eye(n3)
        chain = {}
        if cfg["lvl3"] == "cg":
            E2_inv = jnp.asarray(np.diag(1.0 / np.diag(E2)),
                                 dtype=E_diag.dtype)         # Jacobi
            E2_keep = jnp.asarray(E2, dtype=E_diag.dtype)
            chain = self._build_chain(E2, E_diag.dtype)
        else:
            E2_inv = jnp.asarray(np.linalg.inv(E2), dtype=E_diag.dtype)
            E2_keep = None

        oh = np.zeros((S, K, S + 1), dtype=np.float32)
        for s in range(S):
            for j, q in enumerate(nbr_sub[s]):
                oh[s, j, q] = 1.0

        inner_tol = cfg["inner_tol"]
        if np.asarray(E_diag).dtype == np.float32 and inner_tol < 1e-5:
            # the f32 nested coarse solve floors near 1e-5; asking for
            # more spins the inner iteration to max_it and the returned
            # noise can *diverge* the deflated outer solve
            print(f"WARNING -- level_2_tol {inner_tol:g} clamped to 1e-5 "
                  f"(f32 nested coarse floor; tighter requests poison "
                  f"the outer correction)")
            inner_tol = 1e-5

        return CoarseState(
            Z=Z, E_inv=None, nu_loc=jnp.asarray(nu_loc), E=None,
            nu_max=nu_max, correction=correction, mode="bsr",
            inner_tol=inner_tol, inner_max_it=cfg["inner_max_it"],
            method=cfg["method"], restart=cfg["restart"], prec=cfg["prec"],
            lvl3=cfg["lvl3"], l3_tol=cfg["l3_tol"],
            l3_max_it=cfg["l3_max_it"],
            E2_inv=E2_inv, Z2=None, E2=E2_keep, Eloc_inv=Eloc_inv,
            agg_oh=jnp.asarray(V3h, dtype=E_diag.dtype),
            Eb_diag=E_diag, Eb_nbr=E_nb,
            Eb_diag_inv=Eb_diag_inv, nbr_oh=jnp.asarray(oh), **chain)

    def _assemble_E(self, Z, nu_loc, nu_max, dtype):
        """E[(s,a),(q,b)] = (R_s^T D_s Z_s^a)^T A (R_q^T D_q Z_q^b).

        Batched on device: X = exchange(D Z-as-global-columns) gives every
        subdomain its restriction of all coarse basis vectors; then
        E = sum_s X_s^T D_s (A_s X_s) — one einsum + psum. Replaces the
        reference's per-neighbor block sends (HPDDM_operator.hpp:378-562).
        """
        dec = self.dec
        S, n, _ = Z.shape
        N_c = S * nu_max
        # X0[s, :, (q,b)] = delta_{q,s} (D_s Z_s^b)
        DZ = dec.d[:, :, None] * Z                           # (S, n, nu)
        X0 = jnp.zeros((S, n, N_c), dtype=Z.dtype)
        cols = (jnp.arange(S)[:, None] * nu_max
                + jnp.arange(nu_max)[None, :])               # (S, nu)
        s_idx = jnp.broadcast_to(jnp.arange(S)[:, None, None], (S, n, nu_max))
        r_idx = jnp.broadcast_to(jnp.arange(n)[None, :, None], (S, n, nu_max))
        c_idx = jnp.broadcast_to(cols[:, None, :], (S, n, nu_max))
        X0 = X0.at[s_idx, r_idx, c_idx].set(DZ)
        X = exchange(dec, X0)                                # consistent rep
        Y = spmm(self.A, X)                                  # A_s X_s
        E = jnp.einsum("snp,sn,snq->pq", jnp.conj(X), dec.d, Y)
        # pad empty coarse slots (nonuniform nu) with identity
        slot_active = (jnp.arange(nu_max)[None, :]
                       < jnp.asarray(nu_loc)[:, None]).reshape(-1)
        E = jnp.where(slot_active[:, None] & slot_active[None, :], E,
                      jnp.eye(N_c, dtype=E.dtype))
        coarse_dtype = self.opt.val("coarse_dtype")
        if coarse_dtype not in (None, "same"):
            E = E.astype(coarse_dtype)
        return E
