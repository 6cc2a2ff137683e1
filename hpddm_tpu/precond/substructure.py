"""Substructuring preconditioners: FETI and BDD.

Re-design of the reference's Schur-complement layer
(include/HPDDM_schur.hpp:40-812, HPDDM_FETI.hpp:40-475,
HPDDM_BDD.hpp:40-334):

* local Neumann matrices are factorized as batched dense pseudo-inverses
  (eigh-based; replaces the null-pivot-detecting MUMPS factorizations,
  HPDDM_schur.hpp:338-353) and their kernels (rigid-body modes) are
  extracted from the same eigh,
* the local Schur complements S_s = K_bb - K_bi K_ii^-1 K_ib are formed
  as batched dense blocks (``computeSchurComplement``,
  HPDDM_schur.hpp:356-377),
* FETI's dual space is the fully-redundant Lagrange-multiplier space: one
  multiplier per (unordered subdomain pair, shared dof), matching the
  reference's per-neighbor-list layout (``mult_``/``signed_``,
  HPDDM_schur.hpp:319-334). Multiplier vectors are replicated; B/B^T are
  one gather + scatter-add (+psum when sharded),
* the coarse projection P = I - G (G^T G)^-1 G^T with G = B R uses a
  replicated dense coarse solve (``Feti::project``, HPDDM_FETI.hpp:339-368)
  by default; ``-hpddm_substructuring_coarse mfree`` keeps the solve exact
  but *matrix-free*: G and G^T are applied through the adjoint pairs
  (b_apply o _kernel_expand / _kernel_dots o bt_apply), the BDD balancing
  basis W is never materialized (its dense form is S x nb x S*r —
  quadratic in subdomain count), and the small coarse matrices are
  assembled without their bases (G^H G slot-wise on the host; W^T S W by
  chunked batched applies) — exact iteration parity at any subdomain
  count. ``cheby`` goes further and replaces (G^T G)^-1 / (W^T S W)^-1 by
  a fixed-degree Chebyshev polynomial (a *linear* operator, so projected
  CG stays valid — the same design as the inexact local solves,
  ops/cheby_solve.py, and the answer to the reference's
  InexactCoarseOperator, include/HPDDM_inexact_coarse_operator.hpp:48);
  note cond(G^T G) grows with the subdomain-graph diameter, so cheby's
  FETI projection is for moderate subdomain counts — mfree is the
  scalable exact path,
* BDD works on consistent interface vectors with the balancing
  Neumann-Neumann preconditioner (``Bdd::precond``, HPDDM_BDD.hpp:168+).

Both are driven by the projected-CG solver below (the analogue of
``IterativeMethod::PCG``, HPDDM_CG.hpp:486-580).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hpddm_tpu.core.csr import MatrixCSR
from hpddm_tpu.dtypes import underlying
from hpddm_tpu.options import Options
from hpddm_tpu.parallel.decomposition import Decomposition
from hpddm_tpu.parallel.ops import exchange, psum_if


# ----------------------------------------------------------------------
# state
# ----------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SubstructureState:
    """Batched substructuring state (leading axis = subdomains)."""
    K_pinv: jax.Array        # (S, n, n) pseudo-inverse of local Neumann K_s
    kernels: jax.Array       # (S, n, r_max) kernel basis of K_s (padded)
    r_loc: jax.Array         # (S,) kernel dimensions
    S_b: jax.Array           # (S, nb, nb) local boundary Schur complements
    S_b_pinv: jax.Array      # (S, nb, nb)
    Sb_kernels: jax.Array    # (S, nb, r_max) kernel of S_b (padded)
    sb_r_loc: jax.Array      # (S,)
    K_bi: jax.Array          # (S, nb, ni) boundary-interior coupling
    K_bb: jax.Array          # (S, nb, nb) boundary block (lumped precond)
    bidx: jax.Array          # (S, nb) local indices of interface dofs
    b_mask: jax.Array        # (S, nb) validity
    scaling: jax.Array       # (S, nb) multiplicity scaling on the interface
    Kii_inv: jax.Array       # (S, ni, ni) interior-block inverse
    iidx: jax.Array          # (S, ni) interior dof indices
    i_mask: jax.Array        # (S, ni)
    # FETI multiplier maps: slots over (pair, shared dof)
    lam_id: jax.Array        # (S, L) multiplier global id (pad -> N_l)
    lam_loc: jax.Array       # (S, L) local dof index of the slot
    lam_sign: jax.Array      # (S, L) +1 / -1 / 0(pad)
    # global coarse addressing (sharding-safe: these slice along S, so each
    # shard keeps its *global* column offsets / subdomain ids)
    kern_off: jax.Array      # (S,) first coarse column of each subdomain
    sub_gid: jax.Array       # (S,) global subdomain index
    # coarse (projection) data, replicated; None in matrix-free mode
    G: Optional[jax.Array]   # (N_l, nc) = B * kernels (dense, small)
    GtG_inv: Optional[jax.Array]  # (nc, nc)
    dec_b: Decomposition     # interface-only decomposition (BDD exchange)
    N_l: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    n_max: int = dataclasses.field(metadata=dict(static=True))
    S_total: int = dataclasses.field(metadata=dict(static=True))
    # GenEO deflation space (solve_gevp): lambda-space directions deflated
    # F-orthogonally during the projected CG (Saad deflated-CG structure)
    G_def: Optional[jax.Array] = None      # (N_l, nd)
    FG_def: Optional[jax.Array] = None     # (N_l, nd) = F G_def
    GFG_inv: Optional[jax.Array] = None    # (nd, nd) = (G^T F G)^-1
    # matrix-free (Chebyshev) coarse solves: -hpddm_substructuring_coarse
    coarse_mode: str = dataclasses.field(default="dense",
                                         metadata=dict(static=True))
    coarse_degree: int = dataclasses.field(default=0,
                                           metadata=dict(static=True))
    bdd_coarse_degree: int = dataclasses.field(default=0,
                                               metadata=dict(static=True))
    gtg_lo: Optional[jax.Array] = None     # spectral bounds of G^T G
    gtg_hi: Optional[jax.Array] = None
    wsw_lo: Optional[jax.Array] = None     # spectral bounds of W^T S W
    wsw_hi: Optional[jax.Array] = None
    # matrix-free *local* solves: -hpddm_substructuring_local banded.
    # K^+ = P (K + eps I)^-1 P with residual refinement (exact to roundoff
    # — the eps error is damped by eps/lambda_min per refinement pass and
    # the kernel component is annihilated by the outer projection P);
    # S_b applies become local SpMV + interior banded solves. Removes the
    # dense O(n^2) local cap (K_pinv / Kii_inv / K_bi / S_b stay dummies).
    local_mode: str = dataclasses.field(default="dense",
                                        metadata=dict(static=True))
    k_refine: int = dataclasses.field(default=2, metadata=dict(static=True))
    Kb: Optional[object] = None        # BandedSolver of K + eps I (full rect)
    Kiib: Optional[object] = None      # BandedSolver of K_ii (interior rect)
    A_loc: Optional[object] = None     # packed local matrices (SpMV)
    sb_lo: Optional[jax.Array] = None  # spectral bounds of D S_b D
    sb_hi: Optional[jax.Array] = None
    sb_degree: int = dataclasses.field(default=0, metadata=dict(static=True))


class Substructure:
    """Host-side builder from a non-overlapping decomposition."""

    def __init__(self, mats: Sequence[MatrixCSR],
                 neighbors: Sequence[Sequence[int]],
                 mappings: Sequence[Sequence[np.ndarray]],
                 options: Optional[Options] = None,
                 kernel_tol: float = 1.0e-8, r_max: int = 1,
                 kernels: Optional[Sequence] = None,
                 grid_shapes: Optional[Sequence] = None,
                 slot_maps: Optional[Sequence] = None):
        self.opt = options if options is not None else Options()
        self.S = len(mats)
        S = self.S
        n_loc = np.array([m.n for m in mats])
        n_max = int(n_loc.max())
        self.n_max = n_max

        # -- interface structure ------------------------------------------
        is_interface = [np.zeros(m.n, dtype=bool) for m in mats]
        for s in range(S):
            for idx in mappings[s]:
                is_interface[s][np.asarray(idx)] = True
        nb_loc = np.array([int(m.sum()) for m in is_interface])
        nb_max = int(nb_loc.max())
        ni_loc = n_loc - nb_loc
        ni_max = int(ni_loc.max())

        bidx = np.zeros((S, nb_max), dtype=np.int32)
        b_mask = np.zeros((S, nb_max), dtype=bool)
        iidx = np.zeros((S, ni_max), dtype=np.int32)
        i_mask = np.zeros((S, ni_max), dtype=bool)
        for s in range(S):
            b = np.nonzero(is_interface[s])[0]
            i = np.nonzero(~is_interface[s])[0][: n_loc[s] - len(b)]
            bidx[s, : len(b)] = b
            b_mask[s, : len(b)] = True
            iidx[s, : len(i)] = i
            i_mask[s, : len(i)] = True

        # -- multiplier space (fully redundant, pair-owned) ----------------
        lam_slots: List[List[Tuple[int, int, int]]] = [[] for _ in range(S)]
        next_lam = 0
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                if q < s:
                    continue
                pos = list(neighbors[q]).index(s)
                idx_q = mappings[q][pos]
                for a, bq in zip(np.asarray(idx), np.asarray(idx_q)):
                    lam_slots[s].append((next_lam, int(a), +1))
                    lam_slots[q].append((next_lam, int(bq), -1))
                    next_lam += 1
        N_l = next_lam
        L_max = max(len(sl) for sl in lam_slots)
        lam_id = np.full((S, L_max), N_l, dtype=np.int32)
        lam_loc = np.zeros((S, L_max), dtype=np.int32)
        lam_sign = np.zeros((S, L_max))
        for s, sl in enumerate(lam_slots):
            for k, (lid, loc, sgn) in enumerate(sl):
                lam_id[s, k] = lid
                lam_loc[s, k] = loc
                lam_sign[s, k] = sgn

        # -- interface scaling (Feti/Bdd::buildScaling): multiplicity
        # (1/mult) or stiffness (rho_s / sum_sharers rho_q with rho = local
        # diagonal), -hpddm_substructuring_scaling --------------------------
        sc_kind = self.opt.val("substructuring_scaling")
        diags = [np.asarray(m.scipy().diagonal()).real for m in mats]
        denom = [d.copy() for d in diags]
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                pos = list(neighbors[q]).index(s)
                idx_q = np.asarray(mappings[q][pos])
                denom[s][np.asarray(idx)] += diags[q][idx_q]
        mult = [np.ones(m.n) for m in mats]
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                mult[s][np.asarray(idx)] += 1.0
        scaling = np.zeros((S, nb_max))
        for s in range(S):
            nb = nb_loc[s]
            b = bidx[s, :nb]
            if sc_kind in ("stiffness", "coefficient"):
                scaling[s, :nb] = diags[s][b] / denom[s][b]
            else:
                scaling[s, :nb] = 1.0 / mult[s][b]

        # -- local factorizations: batched dense (default) or matrix-free
        # banded (-hpddm_substructuring_local banded) ----------------------
        dtype = np.result_type(*[m.dtype for m in mats])
        local_mode = self.opt.val("substructuring_local") or "dense"
        Kb = Kiib = A_loc = None
        if local_mode == "banded":
            (kernels_arr, kernels_j, r_loc, Sb_kernels, sb_r_loc, K_pinv,
             S_b, S_b_pinv, K_bb_arr, K_bi, Kii_inv, Kb, Kiib, A_loc) = \
                self._build_banded(mats, n_loc, nb_loc, ni_loc, bidx,
                                   b_mask, iidx, i_mask, dtype, kernels,
                                   grid_shapes, slot_maps)
            kernels = kernels_arr
        else:
            K = np.zeros((S, n_max, n_max), dtype=dtype)
            for s, m in enumerate(mats):
                K[s, : m.n, : m.n] = m.dense()
                pad = np.arange(m.n, n_max)
                K[s, pad, pad] = 1.0
            K = jnp.asarray(K)
            w, V = jnp.linalg.eigh(0.5 * (K + jnp.swapaxes(K, 1, 2)))
            wmax = jnp.max(jnp.abs(w), axis=1, keepdims=True)
            null = jnp.abs(w) <= kernel_tol * wmax
            inv_w = jnp.where(null, 0.0, 1.0 / jnp.where(null, 1.0, w))
            K_pinv = jnp.einsum("snk,sk,smk->snm", V, inv_w, V)
            # kernel basis: smallest-|w| vectors, masked by actual nullity
            null_np = np.asarray(null)
            r_loc = null_np.sum(axis=1)
            r_max_eff = max(int(r_loc.max(initial=0)), 1)
            kernels = np.zeros((S, n_max, r_max_eff), dtype=dtype)
            V_np = np.asarray(V)
            for s in range(S):
                cols = np.nonzero(null_np[s])[0][:r_max_eff]
                for k, c in enumerate(cols):
                    vec = V_np[s, :, c].copy()
                    vec[n_loc[s]:] = 0.0
                    nrm = np.linalg.norm(vec)
                    kernels[s, :, k] = vec / (nrm if nrm > 0 else 1.0)
            # padding rows of the kernel must be zero so jumps ignore them
            kernels_j = jnp.asarray(kernels)

            # -- Schur complements --------------------------------------------
            K_np = np.asarray(K)
            S_b = np.zeros((S, nb_max, nb_max), dtype=dtype)
            K_bb_arr = np.zeros((S, nb_max, nb_max), dtype=dtype)
            K_bi = np.zeros((S, nb_max, ni_max), dtype=dtype)
            Kii_inv = np.zeros((S, ni_max, ni_max), dtype=dtype)
            for s in range(S):
                nb, ni = nb_loc[s], int(ni_loc[s])
                b = bidx[s, :nb]
                i = iidx[s, :ni]
                Kbb = K_np[s][np.ix_(b, b)]
                Kbi = K_np[s][np.ix_(b, i)]
                Kii = K_np[s][np.ix_(i, i)]
                Kii_i = np.linalg.inv(Kii)
                S_b[s, :nb, :nb] = Kbb - Kbi @ Kii_i @ Kbi.T
                pad = np.arange(nb, nb_max)
                S_b[s, pad, pad] = 1.0
                K_bb_arr[s, :nb, :nb] = Kbb
                K_bb_arr[s, pad, pad] = 1.0
                K_bi[s, :nb, :ni] = Kbi
                Kii_inv[s, :ni, :ni] = Kii_i
                padi = np.arange(ni, ni_max)
                Kii_inv[s, padi, padi] = 1.0
            S_b = jnp.asarray(S_b)
            wS, VS = jnp.linalg.eigh(0.5 * (S_b + jnp.swapaxes(S_b, 1, 2)))
            wSmax = jnp.max(jnp.abs(wS), axis=1, keepdims=True)
            nullS = jnp.abs(wS) <= kernel_tol * wSmax
            inv_wS = jnp.where(nullS, 0.0, 1.0 / jnp.where(nullS, 1.0, wS))
            S_b_pinv = jnp.einsum("snk,sk,smk->snm", VS, inv_wS, VS)
            nullS_np = np.asarray(nullS)
            sb_r_loc = nullS_np.sum(axis=1)
            sb_r_max = max(int(sb_r_loc.max(initial=0)), 1)
            Sb_kernels = np.zeros((S, nb_max, sb_r_max), dtype=dtype)
            VS_np = np.asarray(VS)
            for s in range(S):
                cols = np.nonzero(nullS_np[s])[0][:sb_r_max]
                for k, c in enumerate(cols):
                    vec = VS_np[s, :, c].copy()
                    vec[nb_loc[s]:] = 0.0
                    nrm = np.linalg.norm(vec)
                    Sb_kernels[s, :, k] = vec / (nrm if nrm > 0 else 1.0)

        # -- coarse projection G = B * kernels ----------------------------
        nc_cols = [(s, k) for s in range(S)
                   for k in range(int(r_loc[s]) if r_loc[s] else 0)]
        nc = max(len(nc_cols), 1)
        self._coarse_cols = nc_cols
        co_mode = self.opt.val("substructuring_coarse") or "dense"
        if not nc_cols:
            co_mode = "dense"        # nothing to invert; keep the eye path
        G = GtG_inv = None
        kern_off = np.concatenate([[0], np.cumsum(r_loc)[:-1]]).astype(
            np.int64)
        if co_mode == "dense":
            G = np.zeros((N_l, nc), dtype=dtype)
            for c, (s, k) in enumerate(nc_cols):
                for (lid, loc, sgn) in lam_slots[s]:
                    G[lid, c] += sgn * kernels[s, loc, k]
            GtG = G.T.conj() @ G + 1e-14 * np.eye(nc)
            GtG_inv = (np.linalg.inv(GtG) if nc_cols
                       else np.eye(nc, dtype=dtype))
        elif co_mode == "mfree":
            # exact G^H G assembled slot-wise — G itself (N_l x nc, the
            # replicated memory hog) is never formed; each multiplier id is
            # touched by at most two subdomains, so this is O(slots * r)
            from collections import defaultdict
            contrib: dict = defaultdict(list)
            for s in range(S):
                r = int(r_loc[s])
                if r == 0:
                    continue
                for (lid, loc, sgn) in lam_slots[s]:
                    for k in range(r):
                        v = sgn * kernels[s, loc, k]
                        if v != 0.0:
                            contrib[lid].append((kern_off[s] + k, v))
            GtG = np.zeros((nc, nc), dtype=dtype)
            for lst in contrib.values():
                for c1, v1 in lst:
                    for c2, v2 in lst:
                        GtG[c1, c2] += np.conj(v1) * v2
            GtG += 1e-14 * np.eye(nc)
            GtG_inv = np.linalg.inv(GtG)

        # -- interface-only decomposition (for BDD exchange) ---------------
        b_of = [dict() for _ in range(S)]
        for s in range(S):
            for k in range(nb_loc[s]):
                b_of[s][int(bidx[s, k])] = k
        b_mappings = [[np.array([b_of[s][int(x)] for x in np.asarray(idx)],
                                dtype=np.int64)
                       for idx in mappings[s]] for s in range(S)]
        dec_b = Decomposition.from_subdomains(neighbors, b_mappings,
                                              nb_loc.tolist(),
                                              d=None, n_max=nb_max,
                                              scaling="multiplicity",
                                              renumber=False)

        self.state = SubstructureState(
            K_pinv=K_pinv, kernels=kernels_j,
            r_loc=jnp.asarray(r_loc, dtype=jnp.int32),
            S_b=S_b, S_b_pinv=S_b_pinv,
            Sb_kernels=jnp.asarray(Sb_kernels),
            sb_r_loc=jnp.asarray(sb_r_loc, dtype=jnp.int32),
            K_bi=jnp.asarray(K_bi), K_bb=jnp.asarray(K_bb_arr),
            bidx=jnp.asarray(bidx), b_mask=jnp.asarray(b_mask),
            scaling=jnp.asarray(scaling, dtype=dtype),
            Kii_inv=jnp.asarray(Kii_inv),
            iidx=jnp.asarray(iidx), i_mask=jnp.asarray(i_mask),
            lam_id=jnp.asarray(lam_id), lam_loc=jnp.asarray(lam_loc),
            lam_sign=jnp.asarray(lam_sign, dtype=dtype),
            kern_off=jnp.asarray(kern_off, dtype=jnp.int32),
            sub_gid=jnp.arange(S, dtype=jnp.int32),
            G=None if G is None else jnp.asarray(G),
            GtG_inv=None if GtG_inv is None else jnp.asarray(GtG_inv),
            dec_b=dec_b, N_l=N_l, nc=nc, n_max=n_max, S_total=S,
            coarse_mode=co_mode, local_mode=local_mode,
            k_refine=int(self.opt.val("substructuring_refine", 2)),
            Kb=Kb, Kiib=Kiib, A_loc=A_loc)
        if local_mode == "banded":
            self.state = _calibrate_sb(self.state, self.opt)
        if co_mode == "cheby":
            self.state = _calibrate_coarse(self.state, self.opt)

    # ------------------------------------------------------------------
    def _build_banded(self, mats, n_loc, nb_loc, ni_loc, bidx, b_mask,
                      iidx, i_mask, dtype, kernels_in, grid_shapes,
                      slot_maps=None):
        """Matrix-free local factorizations for grid subdomains:
        banded LU of K + eps I (full local rectangle) and of K_ii
        (interior sub-rectangle), packed local matrices for SpMV, dense
        K_bb (lumped preconditioner only), analytic kernels. The O(n^2)
        dense blocks (K_pinv/S_b/S_b_pinv/Kii_inv/K_bi) stay (S,1,1)
        dummies."""
        import scipy.sparse as sp
        from hpddm_tpu.core.formats import pack_local_matrices
        from hpddm_tpu.ops.banded_solve import build_banded_solver
        S = self.S
        n_max = self.n_max
        if grid_shapes is None:
            raise ValueError("substructuring_local=banded needs "
                             "grid_shapes=[(wy, wx), ...] describing the "
                             "row-major local grid ordering")
        # analytic kernels (constants / rigid-body modes), orthonormalized
        r_loc = np.zeros(S, dtype=np.int64)
        cols = []
        for s in range(S):
            ker = None if kernels_in is None else kernels_in[s]
            if ker is None or np.size(ker) == 0:
                cols.append(np.zeros((int(n_loc[s]), 0)))
                continue
            k2 = np.asarray(ker, dtype=np.float64)
            if k2.ndim == 1:
                k2 = k2[:, None]
            q, rr = np.linalg.qr(k2)
            keep = np.abs(np.diag(rr)) > 1e-10 * max(
                np.abs(np.diag(rr)).max(), 1e-300)
            q = q[:, keep]
            cols.append(q)
            r_loc[s] = q.shape[1]
        r_max_eff = max(int(r_loc.max(initial=0)), 1)
        kernels = np.zeros((S, n_max, r_max_eff), dtype=dtype)
        for s in range(S):
            kernels[s, : int(n_loc[s]), : cols[s].shape[1]] = cols[s]

        # banded factor of K (+ eps I on floating subdomains; the eps error
        # is removed by the refinement passes + kernel projection)
        eps_rel = 1e-8 if np.dtype(dtype).itemsize >= 8 else 1e-4
        K_regs, local_boxes = [], []
        for s, m in enumerate(mats):
            Ks = sp.csr_matrix(m.scipy(expand=True), dtype=np.float64)
            if r_loc[s]:
                scale = float(np.abs(Ks.diagonal()).mean())
                Ks = sp.csr_matrix(Ks + (eps_rel * scale)
                                   * sp.identity(Ks.shape[0]))
            K_regs.append(Ks)
            wy, wx = grid_shapes[s]
            if slot_maps is None and wy * wx != int(n_loc[s]):
                raise ValueError(f"subdomain {s}: grid shape {wy}x{wx} "
                                 f"does not match n={n_loc[s]} (pass "
                                 "slot_maps for unfilled boxes)")
            local_boxes.append((0, wx, 0, wy))

        class _W:                      # tiny adapter for build_banded_solver
            def __init__(self, A):
                self._A = A

            def scipy(self, expand=True):
                return self._A

        # method="host": K_regs are eps-regularized *floating* Neumann
        # matrices (near-singular); the device-f32 Schur recursion would
        # cancel catastrophically on the trailing blocks and perturb the
        # near-null modes K^+ must resolve (see precond/schwarz.py GEVP
        # banded path). The well-conditioned interior K_ii factor below
        # stays on the default (device) path.
        Kb = build_banded_solver([_W(K) for K in K_regs], local_boxes,
                                 n_max, dtype=dtype, slot_maps=slot_maps,
                                 method="host")

        # interior sub-rectangles -> banded factor of K_ii (holes
        # embedded via slot maps, like the full-box factor)
        ni_max = iidx.shape[1]
        Kii_list, i_boxes, i_slots = [], [], []
        for s, m in enumerate(mats):
            wy, wx = grid_shapes[s]
            ni = int(ni_loc[s])
            ii = np.asarray(iidx[s, :ni], dtype=np.int64)
            sl = (np.arange(int(n_loc[s])) if slot_maps is None
                  else np.asarray(slot_maps[s], dtype=np.int64))
            pos = sl[ii]
            iy, ix = pos // wx, pos % wx
            wyi = int(iy.max() - iy.min() + 1) if ni else 1
            wxi = int(ix.max() - ix.min() + 1) if ni else 1
            islot = ((iy - (iy.min() if ni else 0)) * wxi
                     + (ix - (ix.min() if ni else 0)))
            if len(np.unique(islot)) != ni:
                raise ValueError(f"subdomain {s}: interior dof set does "
                                 "not embed in a rectangle")
            Ks = sp.csr_matrix(m.scipy(expand=True))
            Kii_list.append(_W(sp.csr_matrix(Ks[ii][:, ii])))
            i_boxes.append((0, wxi, 0, wyi))
            i_slots.append(islot)
        Kiib = build_banded_solver(Kii_list, i_boxes, ni_max, dtype=dtype,
                                   slot_maps=i_slots)

        A_loc = pack_local_matrices(list(mats), n_max=n_max, fmt="auto",
                                    pad_identity=True)
        if hasattr(A_loc, "astype"):
            A_loc = A_loc.astype(jnp.dtype(dtype))

        # K_bb (lumped preconditioner) + boundary traces of the kernels
        nb_max = bidx.shape[1]
        K_bb_arr = np.zeros((S, nb_max, nb_max), dtype=dtype)
        sb_r_loc = np.zeros(S, dtype=np.int64)
        sb_cols = []
        for s, m in enumerate(mats):
            nb = int(nb_loc[s])
            b = np.asarray(bidx[s, :nb], dtype=np.int64)
            Ks = sp.csr_matrix(m.scipy(expand=True))
            K_bb_arr[s, :nb, :nb] = np.asarray(Ks[b][:, b].todense())
            pad = np.arange(nb, nb_max)
            K_bb_arr[s, pad, pad] = 1.0
            tr = cols[s][b] if cols[s].shape[1] else np.zeros((nb, 0))
            if tr.shape[1]:
                q, rr = np.linalg.qr(tr)
                keep = np.abs(np.diag(rr)) > 1e-10 * max(
                    np.abs(np.diag(rr)).max(), 1e-300)
                sb_cols.append(q[:, keep])
                sb_r_loc[s] = int(keep.sum())
            else:
                sb_cols.append(np.zeros((nb, 0)))
        sb_r_max = max(int(sb_r_loc.max(initial=0)), 1)
        Sb_kernels = np.zeros((S, nb_max, sb_r_max), dtype=dtype)
        for s in range(S):
            Sb_kernels[s, : sb_cols[s].shape[0],
                       : sb_cols[s].shape[1]] = sb_cols[s]

        dummy = jnp.zeros((S, 1, 1), dtype=dtype)
        return (kernels, jnp.asarray(kernels), r_loc, Sb_kernels, sb_r_loc,
                dummy, dummy, dummy, K_bb_arr,
                np.zeros((S, 1, 1), dtype=dtype),
                np.zeros((S, 1, 1), dtype=dtype), Kb, Kiib, A_loc)

    # ------------------------------------------------------------------
    def solve_gevp(self, nu: int = 4,
                   threshold: Optional[float] = None,
                   feti_deflation: bool = False) -> SubstructureState:
        """GenEO-substructuring: local Schur pencil S_b v = lambda (D S_b D) v
        (``Schur::solveGEVP``'s potrf/gst/trd/stebz/stein pipeline,
        HPDDM_schur.hpp:161-271), smallest-lambda traces. The selected
        vectors enrich both coarse spaces: BDD's balancing space (appended
        to the Schur kernels) and, with ``feti_deflation=True``, FETI's
        dual space (columns B D v, projected into the kernel-constraint
        complement and used as an F-orthogonal deflation space for the
        projected operator P F P^T). Returns the enriched state (also
        stored on self)."""
        st = self.state
        S, nb = st.bidx.shape
        D = st.scaling
        if st.local_mode == "banded":
            # matrix-free pencil: implicit S_b applies + Chebyshev-refined
            # S_b^+ inside a B-Lanczos loop (no dense Schur anywhere). The
            # kernel directions are projected out, so the returned pairs
            # start at the first non-zero eigenvalue (the dense path lists
            # the r zero modes first; they are already in the balancing
            # space, so the enrichment below is unaffected).
            lam, V = _schur_gevp_lanczos(st, nu)
            # belt-and-braces: zero padded rows of the returned vectors so
            # the enrichment QR below builds a basis orthonormal on valid
            # rows (the Lanczos operators already mask, but the balancing
            # space must not depend on that implementation detail)
            V = jnp.where(st.b_mask[:, :, None], V, 0)
        else:
            # NOTE count semantics differ between local modes: the dense
            # path's eigenvalue list includes the r near-zero kernel modes
            # (they consume `nu`/`threshold` slots and are discarded by the
            # enrichment QR), while the Lanczos path deflates them and
            # returns only nonzero pencil eigenvalues — the same nu can
            # yield a slightly larger effective coarse space in banded mode.
            DSD = st.S_b * D[:, :, None] * D[:, None, :]
            from hpddm_tpu.precond.geneo import solve_gevp_dense
            lam, V = solve_gevp_dense(st.S_b, DSD, nu)
        lam_np, V_np = np.asarray(lam), np.asarray(V)

        counts = np.full(S, nu, dtype=np.int64)
        if threshold is not None and threshold > 0:
            counts = np.minimum(counts,
                                np.maximum((lam_np < threshold).sum(1), 1))
        # BDD: append to the balancing space, per-subdomain orthonormalized
        # (GenEO traces can be nearly dependent with the Schur kernels)
        old_k = np.asarray(st.sb_r_loc)
        new_rmax = max(int((old_k + counts).max()), 1)
        Sb_k = np.zeros((S, nb, new_rmax), dtype=np.asarray(st.S_b).dtype)
        rank = np.zeros(S, dtype=np.int64)
        Sbk_old = np.asarray(st.Sb_kernels)
        for s in range(S):
            cols = [Sbk_old[s, :, k] for k in range(int(old_k[s]))]
            cols += [V_np[s, :, k] for k in range(int(counts[s]))]
            if not cols:
                continue
            M = np.stack(cols, axis=1)
            q, r = np.linalg.qr(M)
            keep = np.abs(np.diag(r)) > 1e-8 * max(np.abs(np.diag(r)).max(),
                                                   1e-30)
            q = q[:, keep]
            Sb_k[s, :, : q.shape[1]] = q
            rank[s] = q.shape[1]
        # FETI: G columns B (D v) — expand traces to full dofs, signed jump
        g_cols = []
        for s in range(S):
            for k in range(int(counts[s])):
                full = np.zeros((1, self.n_max, 1))
                bsel = np.asarray(st.bidx[s])
                msk = np.asarray(st.b_mask[s])
                full[0, bsel[msk], 0] = (np.asarray(D[s]) * V_np[s, :, k])[msk]
                g_cols.append(full)
        G_def = FG_def = GFG_inv = None
        if g_cols and feti_deflation:
            # per-subdomain block: each column lives only on its subdomain
            Xb = np.zeros((S, self.n_max, len(g_cols)))
            c = 0
            for s in range(S):
                for k in range(int(counts[s])):
                    Xb[s, :, c] = np.asarray(g_cols[c])[0, :, 0]
                    c += 1
            Gx = np.asarray(b_apply(st, jnp.asarray(Xb)))     # (N_l, nd)
            # project into the kernel-constraint complement FIRST: the
            # deflation must be F-orthogonal w.r.t. the *projected*
            # operator P F P^T, not F itself (otherwise the two projectors
            # fight and the primal recovery breaks)
            Gx = np.asarray(feti_project(st, jnp.asarray(Gx)))
            q, r = np.linalg.qr(Gx)
            keep = np.abs(np.diag(r)) > 1e-10 * max(
                np.abs(np.diag(r)).max(), 1e-30)
            Gx = q[:, keep]
            if Gx.shape[1]:
                FG = np.asarray(feti_project(
                    st, feti_operator(st, jnp.asarray(Gx))))
                GFG = Gx.T @ FG
                G_def = jnp.asarray(Gx)
                FG_def = jnp.asarray(FG)
                GFG_inv = jnp.asarray(np.linalg.pinv(0.5 * (GFG + GFG.T)))
        st2 = dataclasses.replace(
            st,
            Sb_kernels=jnp.asarray(Sb_k),
            sb_r_loc=jnp.asarray(rank, dtype=jnp.int32),
            G_def=G_def, FG_def=FG_def, GFG_inv=GFG_inv)
        if st.coarse_mode == "cheby":
            # the balancing space changed — re-estimate the W^T S W bounds
            st2 = _calibrate_coarse(st2, self.opt)
        self.state = st2
        return st2


# ----------------------------------------------------------------------
# matrix-free (Chebyshev) coarse solves
# ----------------------------------------------------------------------

def _cheb_inverse(matvec, b, lo, hi, degree: int):
    """Fixed-degree Chebyshev approximation of A^-1 b, spec(A) in [lo, hi].

    A polynomial in A with *fixed* coefficients is a linear operator, so
    projections/preconditioners built from it keep (projected) CG valid —
    same rationale as the inexact local solves (ops/cheby_solve.py)."""
    rdt = underlying(b.dtype)
    theta = (jnp.asarray(hi, rdt) + jnp.asarray(lo, rdt)) / 2.0
    delta = jnp.maximum((jnp.asarray(hi, rdt) - jnp.asarray(lo, rdt)) / 2.0,
                        jnp.asarray(1e-6, rdt) * theta)
    sigma1 = theta / delta

    def step(carry, _):
        x, r, d, rho = carry
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        return (x, r, d, rho_new), None

    c0 = (jnp.zeros_like(b), b, b / theta, 1.0 / sigma1)
    (x, _, d, _), _ = jax.lax.scan(step, c0, None, length=degree)
    return x + d


def _spd_bounds(matvec, v0, its: int = 48):
    """(lmax, lmin) of an SPD operator by power + shifted power iteration."""
    def normalize(v):
        nrm = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2))
        return v / jnp.where(nrm > 0, nrm, 1.0)

    def pw(v, _):
        w = matvec(v)
        return normalize(w), jnp.real(jnp.sum(jnp.conj(v) * w))

    v1, lams = jax.lax.scan(pw, normalize(v0), None, length=its)
    hi = lams[-1]
    shift = 1.05 * hi

    def pw2(v, _):
        w = shift * v - matvec(v)
        return normalize(w), jnp.real(jnp.sum(jnp.conj(v) * w))

    _, lams2 = jax.lax.scan(pw2, v1, None, length=its)
    return hi, shift - lams2[-1]


def _cheb_degree(kappa: float, dtype, override) -> int:
    """Degree reaching ~dtype accuracy: 2 rho^k <= eps, rho=(sqrt(k)-1)/(sqrt(k)+1)."""
    if override:
        return int(override)
    eps = 30.0 * float(np.finfo(np.dtype(dtype)).eps)
    if kappa <= 1.0 + 1e-12:
        return 8
    rho = (np.sqrt(kappa) - 1.0) / (np.sqrt(kappa) + 1.0)
    k = int(np.ceil(np.log(2.0 / eps) / -np.log(max(rho, 1e-12))))
    return int(np.clip(k, 8, 128))


def _calibrate_sb(st: SubstructureState, opt: Options) -> SubstructureState:
    """Spectral bounds of the kernel-deflated local Schur operator (banded
    local mode): drives the fixed-degree Chebyshev S_b^+ of bdd_precond."""
    dtype = st.scaling.dtype
    rdt = underlying(dtype)
    S, nb = st.bidx.shape

    def P(x):
        x = jnp.where(st.b_mask[:, :, None], x, 0)
        q = jnp.einsum("snk,snm->skm", jnp.conj(st.Sb_kernels), x)
        return x - jnp.einsum("snk,skm->snm", st.Sb_kernels, q)

    def mv0(x):
        return P(_sb_apply(st, P(x)))

    v0 = jax.random.normal(jax.random.PRNGKey(41), (S, nb, 1)).astype(dtype)
    hi, _ = _spd_bounds(mv0, v0)
    hi_f = float(hi) * 1.05
    if not hi_f > 0:
        hi_f = 1.0

    def mv1(x):
        # complement (padded + kernel) directions mapped to hi so the
        # shifted power iteration sees only the deflated range spectrum
        return mv0(x) + hi_f * (x - P(x))

    _, lo = _spd_bounds(mv1, v0)
    lo_f = float(np.clip(0.5 * float(lo), 1e-8 * hi_f, 0.9 * hi_f))
    deg = _cheb_degree(hi_f / lo_f, rdt,
                       opt.val("substructuring_local_degree"))
    return dataclasses.replace(
        st, sb_lo=jnp.asarray(lo_f, rdt), sb_hi=jnp.asarray(hi_f, rdt),
        sb_degree=deg)


def _schur_gevp_lanczos(st: SubstructureState, nu: int, ncv: int = None,
                        passes: int = 3, seed: int = 0):
    """GenEO-substructuring pencil S_b v = lambda (D S_b D) v solved
    matrix-free (``-hpddm_substructuring_local banded``): the analogue of
    ``Schur::solveGEVP`` (HPDDM_schur.hpp:161-271) for local sizes where
    the dense Schur pencil is out of reach.

    B-Lanczos (precond/geneo.py::solve_gevp_lanczos) on A^-1 B with
      * B x = D S_b (D x) — two implicit Schur applies' worth of local
        SpMVs + interior banded solves per step,
      * A^-1 = kernel-projected Chebyshev S_b^+ (degree picked for ~dtype
        accuracy by _calibrate_sb) polished by ``passes`` preconditioned-
        Richardson refinements — the same refine idiom as the banded K^+.
    Kernel directions are deflated by the projection, so eigenvalues start
    at the first non-zero pencil value. Returns (lam (S, nu), V (S, nb, nu)).
    """
    from hpddm_tpu.precond.geneo import solve_gevp_lanczos
    S, nb = st.bidx.shape
    dtype = st.scaling.dtype

    def proj(st, x):
        x = jnp.where(st.b_mask[:, :, None], x, 0)
        q = jnp.einsum("snk,snm->skm", jnp.conj(st.Sb_kernels), x)
        return x - jnp.einsum("snk,skm->snm", st.Sb_kernels, q)

    def apply_B(st, x):
        Dx = st.scaling[:, :, None] * jnp.where(st.b_mask[:, :, None], x, 0)
        return st.scaling[:, :, None] * _sb_apply(st, Dx)

    def apply_Ainv(st, z):
        b = proj(st, z)

        def mv(x):
            return proj(st, _sb_apply(st, proj(st, x)))

        def prec(r):
            return proj(st, _cheb_inverse(mv, r, st.sb_lo, st.sb_hi,
                                          st.sb_degree))

        x = prec(b)
        for _ in range(passes):
            x = x + prec(b - mv(x))
        return proj(st, x)

    return solve_gevp_lanczos(apply_Ainv, apply_B, S, nb, nu,
                              ncv=ncv, seed=seed, dtype=dtype, aux=st)


def _G_apply(st: SubstructureState, alpha: jax.Array,
             axis_name: Optional[str] = None) -> jax.Array:
    """G alpha = B (R alpha) — dense when materialized, else matrix-free."""
    if st.G is not None:
        return st.G @ alpha
    return b_apply(st, _kernel_expand(st, alpha), axis_name)


def _Gt_apply(st: SubstructureState, lam: jax.Array,
              axis_name: Optional[str] = None) -> jax.Array:
    """G^T lam = R^T (B^T lam)."""
    if st.G is not None:
        return st.G.T.conj() @ lam
    return _kernel_dots(st, bt_apply(st, lam), axis_name)


def _gtg_solve(st: SubstructureState, rhs: jax.Array,
               axis_name: Optional[str] = None) -> jax.Array:
    """(G^T G)^-1 rhs: exact small inverse (dense/mfree modes) or
    fixed-degree Chebyshev (cheby mode)."""
    if st.GtG_inv is not None:
        return st.GtG_inv @ rhs
    return _cheb_inverse(
        lambda a: _Gt_apply(st, _G_apply(st, a, axis_name), axis_name),
        rhs, st.gtg_lo, st.gtg_hi, st.coarse_degree)


def _balancing_cols(st: SubstructureState) -> jax.Array:
    """(S, r_max) global balancing-column ids: sub_gid * r_max + k."""
    r_max = st.Sb_kernels.shape[2]
    return (st.sub_gid[:, None] * r_max
            + jnp.arange(r_max, dtype=jnp.int32)[None, :])


def _balancing_apply(st: SubstructureState, c: jax.Array,
                     axis_name: Optional[str] = None) -> jax.Array:
    """W c without materializing W: exchange(D Sb_kernels c) -> consistent.
    c: (ncb, mu) replicated, indexed by global balancing columns."""
    W0 = st.scaling[:, :, None] * st.Sb_kernels
    e = jnp.einsum("snk,skm->snm", W0, c[_balancing_cols(st)])
    return exchange(st.dec_b, e, axis_name)


def _balancing_dots(st: SubstructureState, y: jax.Array,
                    axis_name: Optional[str] = None) -> jax.Array:
    """W^T D y for *consistent* interface vectors y — purely local einsum
    (each balancing column is supported on one subdomain and
    sum_copies d = 1, so <exchange(e), D y> = <e, y>), scattered to the
    global (ncb, mu) column layout."""
    S, nb, r_max = st.Sb_kernels.shape
    W0 = st.scaling[:, :, None] * st.Sb_kernels
    loc = jnp.einsum("snk,snm->skm", jnp.conj(W0), y)
    ncb = st.S_total * r_max
    out = jnp.zeros((ncb, y.shape[-1]), dtype=y.dtype)
    out = out.at[_balancing_cols(st).reshape(-1)].add(
        loc.reshape(S * r_max, -1))
    return psum_if(out, axis_name)


def _balancing_active(st: SubstructureState,
                      axis_name: Optional[str] = None) -> jax.Array:
    """(ncb,) bool — which global balancing columns exist."""
    S, _, r_max = st.Sb_kernels.shape
    act = (jnp.arange(r_max)[None, :] < st.sb_r_loc[:, None])
    ncb = st.S_total * r_max
    num = jnp.zeros((ncb,), dtype=jnp.int32)
    num = num.at[_balancing_cols(st).reshape(-1)].add(
        act.reshape(-1).astype(jnp.int32))
    return psum_if(num, axis_name) > 0


def _wsw_matvec(st: SubstructureState, c: jax.Array, active: jax.Array,
                axis_name: Optional[str] = None) -> jax.Array:
    """(W^T S W) c, identity on padded (inactive) balancing slots."""
    y = bdd_operator(st, _balancing_apply(st, c, axis_name), axis_name)
    return jnp.where(active[:, None], _balancing_dots(st, y, axis_name), c)


def _calibrate_coarse(st: SubstructureState,
                      opt: Options) -> SubstructureState:
    """Estimate spectral bounds of G^T G and W^T S W and pick the Chebyshev
    degrees (setup-time; re-run after GenEO enrichment)."""
    dtype = st.scaling.dtype
    rdt = underlying(dtype)
    override = opt.val("substructuring_coarse_degree")

    v0 = jax.random.normal(jax.random.PRNGKey(17), (st.nc, 1)).astype(dtype)
    hi, lo = _spd_bounds(lambda a: _Gt_apply(st, _G_apply(st, a)), v0)
    ghi, glo = float(hi), float(lo)
    if not ghi > 0:
        ghi, glo = 1.0, 0.9
    ghi *= 1.05
    glo = float(np.clip(0.5 * glo, 1e-8 * ghi, 0.9 * ghi))
    gdeg = _cheb_degree(ghi / glo, rdt, override)

    r_max = st.Sb_kernels.shape[2]
    active = _balancing_active(st)
    w0 = jax.random.normal(jax.random.PRNGKey(29),
                           (st.S_total * r_max, 1)).astype(dtype)
    w0 = jnp.where(active[:, None], w0, 0)
    whi, wlo = _spd_bounds(lambda c: _wsw_matvec(st, c, active), w0)
    bhi, blo = float(whi), float(wlo)
    if not bhi > 0:
        bhi, blo = 1.0, 0.9
    bhi *= 1.05
    blo = float(np.clip(0.5 * blo, 1e-8 * bhi, 0.9 * bhi))
    bdeg = _cheb_degree(bhi / blo, rdt, override)

    return dataclasses.replace(
        st, coarse_degree=gdeg, bdd_coarse_degree=bdeg,
        gtg_lo=jnp.asarray(glo, rdt), gtg_hi=jnp.asarray(ghi, rdt),
        wsw_lo=jnp.asarray(blo, rdt), wsw_hi=jnp.asarray(bhi, rdt))


# ----------------------------------------------------------------------
# local applies: dense factors or matrix-free banded
# ----------------------------------------------------------------------

def _gather_b(st: SubstructureState, w: jax.Array) -> jax.Array:
    vb = jnp.take_along_axis(w, st.bidx[:, :, None], axis=1)
    return jnp.where(st.b_mask[:, :, None], vb, 0)


def _scatter_b(st: SubstructureState, vb: jax.Array) -> jax.Array:
    S, nb = st.bidx.shape
    out = jnp.zeros((S, st.n_max, vb.shape[-1]), dtype=vb.dtype)
    s_ix = jnp.broadcast_to(jnp.arange(S)[:, None], (S, nb))
    safe = jnp.where(st.b_mask, st.bidx, st.n_max)
    return out.at[s_ix, safe].set(vb, mode="drop")


def _gather_i(st: SubstructureState, w: jax.Array) -> jax.Array:
    vi = jnp.take_along_axis(w, st.iidx[:, :, None], axis=1)
    return jnp.where(st.i_mask[:, :, None], vi, 0)


def _scatter_i(st: SubstructureState, vi: jax.Array) -> jax.Array:
    S, ni = st.iidx.shape
    out = jnp.zeros((S, st.n_max, vi.shape[-1]), dtype=vi.dtype)
    s_ix = jnp.broadcast_to(jnp.arange(S)[:, None], (S, ni))
    safe = jnp.where(st.i_mask, st.iidx, st.n_max)
    return out.at[s_ix, safe].set(vi, mode="drop")


def _kernel_project(st: SubstructureState, x: jax.Array) -> jax.Array:
    """P x = x - Q (Q^H x) with Q = orthonormal kernel columns (padded
    columns are zero, so no masking is needed)."""
    q = jnp.einsum("snk,snm->skm", jnp.conj(st.kernels), x)
    return x - jnp.einsum("snk,skm->snm", st.kernels, q)


def _k_pinv_apply(st: SubstructureState, w: jax.Array) -> jax.Array:
    """K^+ w: dense pseudo-inverse, or (banded mode) projected regularized
    solve with ``k_refine`` residual-refinement passes — each pass damps
    the regularization error by eps/(lambda+eps); the outer projection
    removes the kernel component exactly."""
    if st.local_mode != "banded":
        return jnp.einsum("snk,skm->snm", st.K_pinv, w)
    from hpddm_tpu.ops.spmv import spmm
    b = _kernel_project(st, w)
    x = st.Kb.solve(b)
    for _ in range(st.k_refine):
        x = x + st.Kb.solve(b - spmm(st.A_loc, x))
    return _kernel_project(st, x)


def _kii_solve(st: SubstructureState, y: jax.Array) -> jax.Array:
    """K_ii^-1 y on interface-condensed interior vectors (iidx order)."""
    if st.local_mode != "banded":
        return jnp.einsum("snk,skm->snm", st.Kii_inv, y)
    return st.Kiib.solve(y)


def _kbi_apply(st: SubstructureState, ui: jax.Array) -> jax.Array:
    """K_bi u_i via one local SpMV (zero-extended interior vector)."""
    if st.local_mode != "banded":
        return jnp.einsum("snk,skm->snm", st.K_bi, ui)
    from hpddm_tpu.ops.spmv import spmm
    return _gather_b(st, spmm(st.A_loc, _scatter_i(st, ui)))


def _kib_apply(st: SubstructureState, ub: jax.Array) -> jax.Array:
    """K_ib u_b = K_bi^T u_b (structurally symmetric local matrices)."""
    if st.local_mode != "banded":
        return jnp.einsum("sbn,sbm->snm", st.K_bi, ub)
    from hpddm_tpu.ops.spmv import spmm
    return _gather_i(st, spmm(st.A_loc, _scatter_b(st, ub)))


def _sb_apply(st: SubstructureState, vb: jax.Array) -> jax.Array:
    """S_b v = K_bb v - K_bi K_ii^-1 K_ib v; explicit dense block or
    (banded mode) implicit via two local SpMVs + one interior solve
    (``applyLocalSchurComplement``'s implicit variant,
    HPDDM_schur.hpp:600-643)."""
    if st.local_mode != "banded":
        return jnp.einsum("snk,skm->snm", st.S_b, vb)
    from hpddm_tpu.ops.spmv import spmm
    w = spmm(st.A_loc, _scatter_b(st, vb))
    z = _kii_solve(st, _gather_i(st, w))
    v2 = spmm(st.A_loc, _scatter_i(st, z))
    return _gather_b(st, w) - _gather_b(st, v2)


def _sb_pinv_apply(st: SubstructureState, z: jax.Array) -> jax.Array:
    """S_b^+ z: dense pseudo-inverse, or (banded mode) fixed-degree
    Chebyshev on the kernel-deflated implicit Schur apply — a *linear*
    operator, so the BDD CG stays valid."""
    if st.local_mode != "banded":
        return jnp.einsum("snk,skm->snm", st.S_b_pinv, z)

    def proj(x):
        q = jnp.einsum("snk,snm->skm", jnp.conj(st.Sb_kernels), x)
        return x - jnp.einsum("snk,skm->snm", st.Sb_kernels, q)

    def mv(x):
        return proj(_sb_apply(st, proj(x)))

    return proj(_cheb_inverse(mv, proj(z), st.sb_lo, st.sb_hi,
                              st.sb_degree))


# ----------------------------------------------------------------------
# FETI runtime (pure functions)
# ----------------------------------------------------------------------

def bt_apply(st: SubstructureState, lam: jax.Array) -> jax.Array:
    """B^T lambda: expand multipliers to signed subdomain traces.
    lam: (N_l, mu) replicated -> (S, n, mu)."""
    S, L = st.lam_id.shape
    mu = lam.shape[-1]
    vals = st.lam_sign[:, :, None] * lam[st.lam_id]          # (S, L, mu)
    out = jnp.zeros((S, st.n_max, mu), dtype=lam.dtype)
    s_ix = jnp.broadcast_to(jnp.arange(S)[:, None], (S, L))
    return out.at[s_ix, st.lam_loc].add(vals)


def b_apply(st: SubstructureState, u: jax.Array,
            axis_name: Optional[str] = None) -> jax.Array:
    """B u: signed jumps across interfaces. u: (S, n, mu) -> (N_l, mu)."""
    vals = st.lam_sign[:, :, None] * jnp.take_along_axis(
        u, st.lam_loc[:, :, None], axis=1)
    mu = u.shape[-1]
    buf = jnp.zeros((st.N_l + 1, mu), dtype=u.dtype)
    buf = buf.at[st.lam_id.reshape(-1)].add(vals.reshape(-1, mu))
    buf = psum_if(buf, axis_name)
    return buf[: st.N_l]


def feti_operator(st: SubstructureState, lam: jax.Array,
                  axis_name: Optional[str] = None) -> jax.Array:
    """F lambda = B K^+ B^T lambda (Feti::A, HPDDM_FETI.hpp:63-87)."""
    w = bt_apply(st, lam)
    u = _k_pinv_apply(st, w)
    return b_apply(st, u, axis_name)


def feti_precond(st: SubstructureState, lam: jax.Array,
                 axis_name: Optional[str] = None,
                 variant: str = "dirichlet") -> jax.Array:
    """Scaled Dirichlet (or lumped) preconditioner
    (Feti::applyLocalPreconditioner, HPDDM_FETI.hpp:271-312)."""
    # scaled expand, restricted to the interface numbering
    S, L = st.lam_id.shape
    mu = lam.shape[-1]
    if variant == "none":
        return lam
    w = bt_apply(st, lam)                                    # (S, n, mu)
    vb = jnp.take_along_axis(w, st.bidx[:, :, None], axis=1)
    vb = jnp.where(st.b_mask[:, :, None], vb, 0)
    vb = st.scaling[:, :, None] * vb
    if variant == "lumped":
        Sb = st.K_bb                    # FetiPrcndtnr::LUMPED
    elif variant == "superlumped":
        diag = jnp.diagonal(st.K_bb, axis1=1, axis2=2)
        yb = diag[:, :, None] * vb      # diagonal of K_bb only
        yb = st.scaling[:, :, None] * yb
        yb = jnp.where(st.b_mask[:, :, None], yb, 0)
        y = jnp.zeros_like(w)
        s_ix = jnp.broadcast_to(jnp.arange(S)[:, None], st.bidx.shape)
        safe_b = jnp.where(st.b_mask, st.bidx, st.n_max)
        y = y.at[s_ix, safe_b].set(yb, mode="drop")
        return b_apply(st, y, axis_name)
    else:
        Sb = None                       # FetiPrcndtnr::DIRICHLET
    yb = (_sb_apply(st, vb) if Sb is None
          else jnp.einsum("snk,skm->snm", Sb, vb))
    yb = st.scaling[:, :, None] * yb
    yb = jnp.where(st.b_mask[:, :, None], yb, 0)
    y = jnp.zeros_like(w)
    s_ix = jnp.broadcast_to(jnp.arange(S)[:, None], st.bidx.shape)
    safe_b = jnp.where(st.b_mask, st.bidx, st.n_max)  # pads dropped
    y = y.at[s_ix, safe_b].set(yb, mode="drop")
    return b_apply(st, y, axis_name)


def feti_project(st: SubstructureState, lam: jax.Array,
                 axis_name: Optional[str] = None) -> jax.Array:
    """P lambda = lambda - G (G^T G)^-1 G^T lambda (Q = I)."""
    coef = _gtg_solve(st, _Gt_apply(st, lam, axis_name), axis_name)
    return lam - _G_apply(st, coef, axis_name)


class FetiResult(NamedTuple):
    u: jax.Array             # (S, n, mu) primal solution (consistent)
    lam: jax.Array
    iterations: jax.Array
    rel_res: jax.Array


def feti_solve(st: SubstructureState, f: jax.Array, tol: float = 1.0e-8,
               max_it: int = 200, axis_name: Optional[str] = None,
               precond: str = "dirichlet") -> FetiResult:
    """Projected PCG on the dual interface problem
    (IterativeMethod::PCG, HPDDM_CG.hpp:486-580; Feti::start,
    HPDDM_FETI.hpp:142-184)."""
    mu = f.shape[-1]
    rdtype = underlying(f.dtype)

    # dual RHS d = B K^+ f ; compatibility e = R^T f
    Kf = _k_pinv_apply(st, f)
    d = b_apply(st, Kf, axis_name)
    e = _kernel_dots(st, f, axis_name)                       # (nc, mu)
    lam0 = _G_apply(st, _gtg_solve(st, e, axis_name), axis_name)

    defl = st.G_def is not None
    if defl:
        # deflation initialization on the constraint-projected residual
        r_tmp = feti_project(st, d - feti_operator(st, lam0, axis_name),
                             axis_name)
        lam0 = lam0 + st.G_def @ (st.GFG_inv @ (st.G_def.T.conj() @ r_tmp))
    r0 = feti_project(st, d - feti_operator(st, lam0, axis_name), axis_name)
    norm = jnp.sqrt(jnp.sum(jnp.abs(r0) ** 2, axis=0)).astype(rdtype)
    norm = jnp.where(norm > 0, norm, 1.0)

    def prec(r):
        z = feti_precond(st, r, axis_name, precond)
        z = feti_project(st, z, axis_name)
        if defl:
            # keep search directions F-orthogonal to the deflation space
            z = z - st.G_def @ (st.GFG_inv @ (st.FG_def.T.conj() @ z))
        return z

    class Carry(NamedTuple):
        lam: jax.Array
        r: jax.Array
        p: jax.Array
        rz: jax.Array
        it: jax.Array
        res: jax.Array

    z0 = prec(r0)
    rz0 = jnp.sum(jnp.conj(r0) * z0, axis=0)

    def cond(c: Carry):
        return (c.it <= max_it) & jnp.any(c.res > tol)

    def body(c: Carry) -> Carry:
        q = feti_project(st, feti_operator(st, c.p, axis_name), axis_name)
        pq = jnp.sum(jnp.conj(c.p) * q, axis=0)
        alpha = c.rz / jnp.where(jnp.abs(pq) > 0, pq, 1.0)
        lam = c.lam + alpha[None, :] * c.p
        r = c.r - alpha[None, :] * q
        z = prec(r)
        rz = jnp.sum(jnp.conj(r) * z, axis=0)
        beta = rz / jnp.where(jnp.abs(c.rz) > 0, c.rz, 1.0)
        p = z + beta[None, :] * c.p
        res = (jnp.sqrt(jnp.sum(jnp.abs(r) ** 2, axis=0)) / norm).astype(rdtype)
        return Carry(lam, r, p, rz, c.it + 1, res)

    c0 = Carry(lam0, r0, z0, rz0, jnp.int32(1),
               jnp.full((mu,), jnp.inf, dtype=rdtype))
    cf = jax.lax.while_loop(cond, body, c0)

    # primal recovery (Feti::computeSolution, HPDDM_FETI.hpp:396-425):
    # only the *kernel* columns of G determine the floating-mode
    # amplitudes; GenEO enrichment columns are projection-only
    w = f - bt_apply(st, cf.lam)
    u = _k_pinv_apply(st, w)
    jump_u = b_apply(st, u, axis_name)
    alpha = -_gtg_solve(st, _Gt_apply(st, jump_u, axis_name), axis_name)
    u = u + _kernel_expand(st, alpha)
    return FetiResult(u=u, lam=cf.lam, iterations=cf.it - 1, rel_res=cf.res)


def _kernel_dots(st: SubstructureState, f: jax.Array,
                 axis_name: Optional[str]) -> jax.Array:
    """e[(s,k)] = kernels_s[:,k]^T f_s -> (nc,) stacked like G columns.

    Columns are ordered (s, k), k < r_loc[s]; the *global* column of
    subdomain s starts at kern_off[s], so the scatter stays correct when
    the leading axis is a shard of the global subdomain set."""
    local = jnp.einsum("snk,snm->skm", jnp.conj(st.kernels), f)
    S, _, r_max = st.kernels.shape
    mu = f.shape[-1]
    flat = local.reshape(S * r_max, mu)
    active = (jnp.arange(r_max)[None, :] < st.r_loc[:, None])
    idx = (st.kern_off[:, None] + jnp.arange(r_max)[None, :])
    idx = jnp.where(active, idx, st.nc).reshape(-1)
    out = jnp.zeros((st.nc, mu), dtype=f.dtype)
    out = out.at[idx].add(
        jnp.where(active.reshape(-1)[:, None], flat, 0), mode="drop")
    return psum_if(out, axis_name) if axis_name else out


def _kernel_expand(st: SubstructureState, alpha: jax.Array) -> jax.Array:
    """u += R alpha with the same global (s, k) column ordering."""
    S, n, r_max = st.kernels.shape
    mu = alpha.shape[-1]
    active = (jnp.arange(r_max)[None, :] < st.r_loc[:, None])
    idx = st.kern_off[:, None] + jnp.arange(r_max)[None, :]
    full = jnp.where(active[:, :, None],
                     alpha[jnp.where(active, idx, 0)], 0)   # (S, r_max, mu)
    return jnp.einsum("snk,skm->snm", st.kernels, full)


# ----------------------------------------------------------------------
# BDD runtime
# ----------------------------------------------------------------------

def bdd_operator(st: SubstructureState, ub: jax.Array,
                 axis_name: Optional[str] = None) -> jax.Array:
    """Global Schur action on consistent interface vectors:
    sum R^T S_s R u (Bdd::apply, HPDDM_BDD.hpp:151-160)."""
    y = _sb_apply(st, ub)
    return exchange(st.dec_b, y, axis_name)


def bdd_precond(st: SubstructureState, r: jax.Array,
                axis_name: Optional[str] = None) -> jax.Array:
    """Neumann-Neumann: sum R^T D S_s^+ D R r (Bdd::precond)."""
    z = st.scaling[:, :, None] * r
    z = _sb_pinv_apply(st, z)
    z = st.scaling[:, :, None] * z
    return exchange(st.dec_b, z, axis_name)


class BddResult(NamedTuple):
    u: jax.Array             # (S, n, mu) primal solution on full dofs
    iterations: jax.Array
    rel_res: jax.Array


def bdd_solve(st: SubstructureState, f: jax.Array, tol: float = 1.0e-8,
              max_it: int = 200,
              axis_name: Optional[str] = None) -> BddResult:
    """Balanced Neumann-Neumann on the interface: deflated CG with the
    local-Schur-kernel coarse space (the 'balancing' of BDD), then interior
    recovery u_i = K_ii^-1 (f_i - K_ib u_b)."""
    mu = f.shape[-1]
    rdtype = underlying(f.dtype)
    S, nb = st.bidx.shape

    # condensed RHS g = exchange(f_b - K_bi K_ii^-1 f_i)
    # (Schur::condensateEffort, HPDDM_schur.hpp:724)
    fi = jnp.take_along_axis(f, st.iidx[:, :, None], axis=1)
    fi = jnp.where(st.i_mask[:, :, None], fi, 0)
    ui0 = _kii_solve(st, fi)
    fb = jnp.take_along_axis(f, st.bidx[:, :, None], axis=1)
    fb = jnp.where(st.b_mask[:, :, None], fb, 0)
    g_loc = fb - _kbi_apply(st, ui0)
    g = exchange(st.dec_b, g_loc, axis_name)

    # balancing coarse space: columns W^(s,k) = exchange(D_s Sb_kernel)
    _, _, r_max = st.Sb_kernels.shape
    ncb = st.S_total * r_max
    active = _balancing_active(st, axis_name)                # (ncb,)
    dw = st.dec_b.d[:, :, None]

    if st.coarse_mode == "cheby":
        # matrix-free: W never materialized (dense form is (S, nb, S*r) —
        # quadratic in subdomain count), (W^T S W)^-1 by fixed-degree
        # Chebyshev with setup-estimated bounds
        def coarse(r):
            rhs = jnp.where(active[:, None],
                            _balancing_dots(st, r, axis_name), 0)
            c = _cheb_inverse(
                lambda x: _wsw_matvec(st, x, active, axis_name),
                rhs, st.wsw_lo, st.wsw_hi, st.bdd_coarse_degree)
            c = jnp.where(active[:, None], c, 0)
            return _balancing_apply(st, c, axis_name), c
    elif st.coarse_mode == "mfree":
        # exact W^T S W assembled by chunked matrix-free applies — W
        # itself ((S, nb, S*r): quadratic in subdomain count) is never
        # materialized; peak extra memory is one (S, nb, chunk) slab
        chunk = min(128, ncb)
        eye = jnp.eye(ncb, dtype=f.dtype)
        blocks = []
        for c0 in range(0, ncb, chunk):
            E = eye[:, c0:c0 + chunk]
            blocks.append(_balancing_dots(
                st, bdd_operator(st, _balancing_apply(st, E, axis_name),
                                 axis_name), axis_name))
        WtSW = jnp.concatenate(blocks, axis=1)
        WtSW = jnp.where(active[:, None] & active[None, :], WtSW, eye)
        WtSW_inv = jnp.linalg.pinv(0.5 * (WtSW + WtSW.T.conj()))

        def coarse(r):
            c = WtSW_inv @ jnp.where(active[:, None],
                                     _balancing_dots(st, r, axis_name), 0)
            return _balancing_apply(st, c, axis_name), c
    else:
        W0 = st.scaling[:, :, None] * st.Sb_kernels          # (S, nb, r)
        cols = _balancing_cols(st)
        Wg = jnp.zeros((S, nb, ncb), dtype=f.dtype)
        s_ix = jnp.broadcast_to(jnp.arange(S)[:, None, None], (S, nb, r_max))
        n_ix = jnp.broadcast_to(jnp.arange(nb)[None, :, None], (S, nb, r_max))
        c_ix = jnp.broadcast_to(cols[:, None, :], (S, nb, r_max))
        Wg = Wg.at[s_ix, n_ix, c_ix].set(W0)
        W = exchange(st.dec_b, Wg, axis_name)                # consistent cols

        def wdot(X, y):
            """consistent-vector dots: (S,nb,k)^T D y -> (k, mu)."""
            local = jnp.einsum("snk,snm->km", jnp.conj(X), dw * y)
            return psum_if(local, axis_name)

        SW = bdd_operator(st, W, axis_name)                  # (S, nb, ncb)
        WtSW = wdot(W, SW)                                   # (ncb, ncb)
        eye = jnp.eye(ncb, dtype=f.dtype)
        WtSW = jnp.where(active[:, None] & active[None, :], WtSW, eye)
        WtSW_inv = jnp.linalg.pinv(0.5 * (WtSW + WtSW.T.conj()))

        def coarse(r):
            c = WtSW_inv @ jnp.where(active[:, None], wdot(W, r), 0)
            return jnp.einsum("snk,km->snm", W, c), c

    u0, _ = coarse(g)
    r0 = g - bdd_operator(st, u0, axis_name)

    def prec(r):
        z = bdd_precond(st, r, axis_name)
        # balance: z <- z - W (W^T S W)^-1 W^T S z
        Sz = bdd_operator(st, z, axis_name)
        zc, _ = coarse(Sz)
        return z - zc

    norm = jnp.sqrt(jnp.abs(psum_if(jnp.einsum(
        "snm,snm->m", jnp.conj(g), dw * g), axis_name))).astype(rdtype)
    norm = jnp.where(norm > 0, norm, 1.0)

    class Carry(NamedTuple):
        u: jax.Array
        r: jax.Array
        p: jax.Array
        rz: jax.Array
        it: jax.Array
        res: jax.Array

    def vdot(x, y):
        return psum_if(jnp.einsum("snm,snm->m", jnp.conj(x), dw * y),
                       axis_name)

    z0 = prec(r0)
    rz0 = vdot(r0, z0)

    def cond(c: Carry):
        return (c.it <= max_it) & jnp.any(c.res > tol)

    def body(c: Carry) -> Carry:
        q = bdd_operator(st, c.p, axis_name)
        pq = vdot(c.p, q)
        alpha = c.rz / jnp.where(jnp.abs(pq) > 0, pq, 1.0)
        u = c.u + alpha[None, None, :] * c.p
        r = c.r - alpha[None, None, :] * q
        z = prec(r)
        rz = vdot(r, z)
        beta = rz / jnp.where(jnp.abs(c.rz) > 0, c.rz, 1.0)
        p = z + beta[None, None, :] * c.p
        res = (jnp.sqrt(jnp.abs(vdot(r, r))) / norm).astype(rdtype)
        return Carry(u, r, p, rz, c.it + 1, res)

    c0 = Carry(u0, r0, z0, rz0, jnp.int32(1),
               jnp.full((mu,), jnp.inf, dtype=rdtype))
    cf = jax.lax.while_loop(cond, body, c0)

    # interior recovery on full local numbering:
    # u_i = K_ii^-1 (f_i - K_ib u_b)  (originalNumbering analogue)
    ub = cf.u
    ui = _kii_solve(st, fi - _kib_apply(st, ub))
    u_full = jnp.zeros((S, st.n_max, mu), dtype=f.dtype)
    s_b = jnp.broadcast_to(jnp.arange(S)[:, None], st.bidx.shape)
    safe_b = jnp.where(st.b_mask, st.bidx, st.n_max)
    u_full = u_full.at[s_b, safe_b].set(ub, mode="drop")
    s_i = jnp.broadcast_to(jnp.arange(S)[:, None], st.iidx.shape)
    safe_i = jnp.where(st.i_mask, st.iidx, st.n_max)
    u_full = u_full.at[s_i, safe_i].set(ui, mode="drop")
    return BddResult(u=u_full, iterations=cf.it - 1, rel_res=cf.res)
