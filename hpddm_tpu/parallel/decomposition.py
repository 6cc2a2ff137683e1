"""Subdomain decomposition: the replacement of ``Subdomain<K>``.

The reference keeps, per MPI rank, a neighbor map ``map_`` = vector of
(rank, list-of-shared-local-indices) and implements ``exchange`` as
Irecv/gthr/Isend/Waitany + add (include/HPDDM_subdomain.hpp:39-130).

Here all subdomains are a *batch*: a leading axis ``S`` sharded over the
device mesh. Host-side setup (this file, numpy) resolves the pairwise
neighbor lists into one global *interface numbering* via union-find, so that
the runtime exchange is a dense fixed-shape program (see parallel/ops.py):

    gather interface values -> scatter-add into an (n_if,)-sized buffer
    -> psum over the mesh axis -> gather back -> scatter into place.

This is mathematically identical to the reference's sum-reduce of duplicated
unknowns, but deterministic (fixed reduction order, unlike Waitany) and
shape-static for XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from hpddm_tpu.core.csr import MatrixCSR
from hpddm_tpu.core.formats import pack_local_matrices


def restrict_pou(neighbors, mappings, d_list) -> bool:
    """Round a partition of unity to boolean ownership in place
    (``Schwarz::restriction``, HPDDM_schwarz.hpp:277-333).

    Every shared dof whose value is fractional — or whose copies do not
    sum to 1 — is assigned to the sharer with the strictly largest value
    (ties to the higher subdomain id): that copy becomes 1, the others 0.
    Returns whether anything changed. d_list: per-subdomain (n_s,) arrays,
    caller numbering, modified in place."""
    from hpddm_tpu.native import uf_resolve
    S = len(neighbors)
    n_loc = np.array([len(d) for d in d_list], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_loc)])
    pa, pb = [], []
    for s in range(S):
        for q, idx in zip(neighbors[s], mappings[s]):
            if q < s:
                continue
            pos = list(neighbors[q]).index(s)
            pa.append(offsets[s] + np.asarray(idx, dtype=np.int64))
            pb.append(offsets[q] + np.asarray(mappings[q][pos],
                                              dtype=np.int64))
    roots = uf_resolve(int(offsets[-1]),
                       np.concatenate(pa) if pa else np.zeros(0, np.int64),
                       np.concatenate(pb) if pb else np.zeros(0, np.int64))
    flat = np.concatenate([np.asarray(dd, dtype=np.float64)
                           for dd in d_list])
    eps = 1.0e-12
    # group-by root with sorted segments — no per-dof Python
    # (round-3: the dict loop was O(total dofs) interpreted, unusable at
    # the 1M-dof flagship; see tests/test_matrix_exchange.py time budget)
    order = np.argsort(roots, kind="stable")      # ascending g within root
    rs = np.asarray(roots)[order]
    starts = np.flatnonzero(np.concatenate([[True], rs[1:] != rs[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(rs)]]))
    vals = flat[order]
    gmax = np.maximum.reduceat(vals, starts)
    gsum = np.add.reduceat(vals, starts)
    frac = np.add.reduceat(
        ((np.abs(vals - 1.0) > eps) & (np.abs(vals) > eps)).astype(np.int64),
        starts) > 0
    needs = (counts > 1) & (frac | (np.abs(gsum - 1.0) > eps))
    if not np.any(needs):
        return False
    gid = np.repeat(np.arange(len(starts)), counts)
    # winner per group: largest value, ties to the higher subdomain id =
    # the *last* position attaining the max (members ascend by global dof)
    ismax = vals >= gmax[gid] - 0.0                # exact max matches
    pos = np.arange(len(vals))
    win = np.maximum.reduceat(np.where(ismax, pos, -1), starts)
    new_vals = np.where(needs[gid], 0.0, vals)
    new_vals[win[needs]] = 1.0
    changed = bool(np.any(np.abs(new_vals - vals) > eps))
    if changed:
        flat[order] = new_vals
        for s in range(S):
            d_list[s][:] = flat[offsets[s]: offsets[s + 1]]
    return changed


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Device-side decomposition state (pytree; leading axis = subdomains).

    Attributes
    ----------
    n_loc : (S,) int32 — actual local size of each subdomain (<= n_max).
    d : (S, n_max) — partition of unity (``Schwarz::d_``); zero on padding.
    if_idx : (S, m_max) int32 — local indices of interface (duplicated) dofs.
    if_gid : (S, m_max) int32 — global interface id of each, padded to n_if.
    if_mask : (S, m_max) bool — validity of each slot.
    ov_mask : (S, n_max) bool — union of the neighbor lists (the geometric
        overlap region; used by ``scaleIntoOverlap`` for GenEO).
    mult : (S, n_max) — multiplicity of each dof (# subdomains sharing it).
    """
    n_loc: jax.Array
    d: jax.Array
    if_idx: jax.Array
    if_gid: jax.Array
    if_mask: jax.Array
    ov_mask: jax.Array
    mult: jax.Array
    # scatter-free exchange tables:
    # partners[s, k, :] = flattened global slot ids (q * m_max + j) of the
    # other copies of slot (s, k); sentinel = S * m_max (a zero pad slot).
    partners: jax.Array        # (S, m_max, k_max) int32
    # inv_map[s, i] = interface slot of local dof i, sentinel m_max
    inv_map: jax.Array         # (S, n_max) int32
    is_if: jax.Array           # (S, n_max) bool
    # interface-first renumbering (fast path): local dofs are permuted
    # so slot k lives at position k; exchange touches only x[:, :m_max].
    # perm[s, p] = original local index now at position p; iperm inverse.
    # None when the decomposition keeps the caller's numbering.
    perm: Optional[jax.Array]   # (S, n_max) int32 or None
    iperm: Optional[jax.Array]  # (S, n_max) int32 or None
    S: int = dataclasses.field(metadata=dict(static=True))
    n_max: int = dataclasses.field(metadata=dict(static=True))
    m_max: int = dataclasses.field(metadata=dict(static=True))
    n_if: int = dataclasses.field(metadata=dict(static=True))
    n_global: int = dataclasses.field(metadata=dict(static=True))
    k_max: int = dataclasses.field(metadata=dict(static=True))
    renumbered: bool = dataclasses.field(default=False,
                                         metadata=dict(static=True))
    # distinct subdomain offsets q - s over all partner pairs (static,
    # sorted). Under shard_map this bounds which *devices* hold partners,
    # so the exchange can ppermute only neighbor slabs instead of
    # all_gathering the full interface (HPDDM's halo is point-to-point
    # with neighbors only, HPDDM_subdomain.hpp:115-130; per-iteration comm
    # must be O(local interface), not O(total)).
    sub_shifts: tuple = dataclasses.field(default=(),
                                          metadata=dict(static=True))
    # optional structured-grid halo plan (parallel/grid.py); when present
    # `exchange` uses the scatter-free slab path
    grid: Optional[object] = None
    # row-level exchange plan (parallel/rowplan.py): unique sorted 128-wide
    # row gathers/scatters replace the element-granular ones on the general
    # path
    rowplan: Optional[object] = None

    # ------------------------------------------------------------------
    @staticmethod
    def from_subdomains(neighbors: Sequence[Sequence[int]],
                        mappings: Sequence[Sequence[np.ndarray]],
                        n_loc: Sequence[int],
                        d: Optional[Sequence[np.ndarray]] = None,
                        n_max: Optional[int] = None,
                        scaling: str = "normalized",
                        renumber: bool = False,
                        dtype=np.float64) -> "Decomposition":
        """Build from HPDDM-style neighbor lists.

        neighbors[s] = list of neighbor subdomain ids (any order; the
        reference sorts by rank — Subdomain::initialize,
        HPDDM_subdomain.hpp:166-236).
        mappings[s][j] = local indices of the dofs shared with
        neighbors[s][j]; the lists of the two sides of a pair are aligned
        elementwise (the property HPDDM's buffer exchange relies on).
        d[s] = partition of unity; if None, 1/multiplicity scaling is used.
        scaling:
          * "normalized" — d_i <- d_i / sum_sharers d_q, the fixed point of
            ``multiplicityScaling`` applied to a user d
            (HPDDM_schwarz.hpp:381-404; examples/schwarz.cpp always runs it),
          * "given" — use d exactly as passed,
          * "multiplicity" — ignore d, use 1/multiplicity.
        """
        S = len(neighbors)
        n_loc = np.asarray(n_loc, dtype=np.int64)
        if n_max is None:
            n_max = int(n_loc.max()) if S else 0

        offsets = np.concatenate([[0], np.cumsum(n_loc)])
        total = int(offsets[-1])
        pairs_a, pairs_b = [], []
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                if q < s:
                    continue  # handle each pair once, from the lower side
                # find the matching list on the q side
                try:
                    pos = list(neighbors[q]).index(s)
                except ValueError as e:
                    raise ValueError(f"neighbor lists inconsistent: {s}<->{q}") from e
                idx_q = mappings[q][pos]
                if len(idx) != len(idx_q):
                    raise ValueError(
                        f"mapping length mismatch between {s} and {q}: "
                        f"{len(idx)} vs {len(idx_q)}")
                pairs_a.append(offsets[s] + np.asarray(idx, dtype=np.int64))
                pairs_b.append(offsets[q] + np.asarray(idx_q, dtype=np.int64))

        from hpddm_tpu.native import uf_resolve
        roots = uf_resolve(
            total,
            np.concatenate(pairs_a) if pairs_a else np.zeros(0, np.int64),
            np.concatenate(pairs_b) if pairs_b else np.zeros(0, np.int64))
        # interface dofs: classes with more than one member
        unique_roots, counts = np.unique(roots, return_counts=True)
        class_size = dict(zip(unique_roots.tolist(), counts.tolist()))
        shared = np.array([class_size[r] > 1 for r in roots])
        if_roots = np.unique(roots[shared])
        gid_of_root = {int(r): k for k, r in enumerate(if_roots)}
        n_if = len(if_roots)
        n_global = len(unique_roots)

        m_count = np.zeros(S, dtype=np.int64)
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            m_count[s] = int(shared[lo:hi].sum())
        m_max = int(m_count.max(initial=1))

        if_idx = np.zeros((S, m_max), dtype=np.int32)
        if_gid = np.full((S, m_max), n_if, dtype=np.int32)
        if_mask = np.zeros((S, m_max), dtype=bool)
        mult = np.zeros((S, n_max), dtype=dtype)
        ov_mask = np.zeros((S, n_max), dtype=bool)
        inv_map = np.full((S, n_max), m_max, dtype=np.int32)
        class_slots: dict = {}
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            loc = np.nonzero(shared[lo:hi])[0]
            if_idx[s, : len(loc)] = loc
            if_gid[s, : len(loc)] = [gid_of_root[int(roots[lo + i])] for i in loc]
            if_mask[s, : len(loc)] = True
            inv_map[s, loc] = np.arange(len(loc), dtype=np.int32)
            for k, i in enumerate(loc):
                class_slots.setdefault(int(roots[lo + i]), []).append(
                    s * m_max + k)
            mult[s, : n_loc[s]] = [class_size[int(r)] for r in roots[lo:hi]]
            for idx in mappings[s]:
                ov_mask[s, np.asarray(idx, dtype=np.int64)] = True

        # partner tables: each slot lists the other copies of its class
        k_max = max((len(v) - 1 for v in class_slots.values()), default=1)
        k_max = max(k_max, 1)
        sentinel = S * m_max
        partners = np.full((S, m_max, k_max), sentinel, dtype=np.int32)
        for members in class_slots.values():
            for me in members:
                others = [p for p in members if p != me]
                s_i, k_i = divmod(me, m_max)
                partners[s_i, k_i, : len(others)] = others
        # static set of subdomain offsets (q - s) with any shared dof
        valid = partners != sentinel
        src = np.broadcast_to(np.arange(S)[:, None, None], partners.shape)
        sub_shifts = tuple(
            int(v) for v in np.unique(partners[valid] // m_max
                                      - src[valid])) if valid.any() else ()

        d_arr = np.zeros((S, n_max), dtype=dtype)
        if d is None or scaling == "multiplicity":
            for s in range(S):
                d_arr[s, : n_loc[s]] = 1.0 / mult[s, : n_loc[s]]
        else:
            for s in range(S):
                d_arr[s, : n_loc[s]] = np.asarray(d[s], dtype=dtype)
            if scaling == "normalized":
                # class-wise normalization: d_i <- d_i / sum_{sharers} d_q
                # (the order-independent fixed point of multiplicityScaling)
                class_sum: dict = {}
                for s in range(S):
                    lo = offsets[s]
                    for i in range(n_loc[s]):
                        r = int(roots[lo + i])
                        class_sum[r] = class_sum.get(r, 0.0) + d_arr[s, i]
                for s in range(S):
                    lo = offsets[s]
                    for i in range(n_loc[s]):
                        v = d_arr[s, i]
                        if abs(v) < 1.0e-12:
                            d_arr[s, i] = 0.0
                        else:
                            d_arr[s, i] = v / class_sum[int(roots[lo + i])]

        perm = iperm = None
        if renumber:
            # interface-first renumbering: slot k -> position k, interior
            # next, pads last. The runtime exchange then touches only the
            # contiguous block x[:, :m_max] (no full-vector gathers — the
            # analogue of Schur::renumber's interior/interface split).
            perm = np.zeros((S, n_max), dtype=np.int32)
            iperm = np.zeros((S, n_max), dtype=np.int32)
            for s in range(S):
                mc = int(m_count[s])
                iface = if_idx[s, :mc]
                interior_mask = np.ones(n_loc[s], dtype=bool)
                interior_mask[iface] = False
                interior = np.nonzero(interior_mask)[0]
                order = np.concatenate([
                    iface, interior,
                    np.arange(n_loc[s], n_max, dtype=np.int64)])
                perm[s] = order
                iperm[s, order] = np.arange(n_max, dtype=np.int32)
                # permute per-dof arrays into the new layout
                d_arr[s] = d_arr[s][order]
                mult[s] = mult[s][order]
                ov_mask[s] = ov_mask[s][order]
            if_idx = np.broadcast_to(np.arange(m_max, dtype=np.int32),
                                     (S, m_max)).copy()
            inv_map = np.broadcast_to(
                np.where(np.arange(n_max) < m_max,
                         np.arange(n_max), m_max).astype(np.int32),
                (S, n_max)).copy()
            is_if_arr = (np.arange(n_max)[None, :]
                         < m_count[:, None]).astype(bool)
        else:
            is_if_arr = inv_map < m_max

        rowplan = None
        if not renumber:
            from hpddm_tpu.parallel.rowplan import RowPlan
            rowplan = RowPlan.build(if_idx, if_mask, int(n_max))

        return Decomposition(
            n_loc=jnp.asarray(n_loc, dtype=jnp.int32),
            d=jnp.asarray(d_arr),
            if_idx=jnp.asarray(if_idx),
            if_gid=jnp.asarray(if_gid),
            if_mask=jnp.asarray(if_mask),
            ov_mask=jnp.asarray(ov_mask),
            mult=jnp.asarray(mult),
            partners=jnp.asarray(partners),
            inv_map=jnp.asarray(inv_map),
            is_if=jnp.asarray(is_if_arr),
            perm=jnp.asarray(perm) if perm is not None else None,
            iperm=jnp.asarray(iperm) if iperm is not None else None,
            S=S, n_max=int(n_max), m_max=m_max, n_if=n_if, n_global=n_global,
            k_max=int(k_max), renumbered=bool(renumber),
            sub_shifts=sub_shifts,
            rowplan=rowplan,
        )

    # ------------------------------------------------------------------
    def permute(self, x: jax.Array) -> jax.Array:
        """Original -> internal (interface-first) numbering; identity when
        not renumbered. x: (S, n_max, ...)."""
        if not self.renumbered:
            return x
        return jnp.take_along_axis(
            x, self.perm[:, :, None] if x.ndim == 3 else self.perm, axis=1)

    def unpermute(self, x: jax.Array) -> jax.Array:
        """Internal -> original numbering."""
        if not self.renumbered:
            return x
        return jnp.take_along_axis(
            x, self.iperm[:, :, None] if x.ndim == 3 else self.iperm,
            axis=1)

    def global_mapping(self, neighbors, mappings, n_loc):
        """Owner-based contiguous global numbering (``Subdomain::
        globalMapping``, HPDDM_subdomain.hpp:471-544): each duplicated dof
        is owned by its lowest-id sharer; owners number their dofs in
        subdomain-major order. Returns (list of (n_loc[s],) int64 arrays,
        n_global)."""
        from hpddm_tpu.native import uf_resolve
        S = len(neighbors)
        n_loc = np.asarray(n_loc, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_loc)])
        pa, pb = [], []
        for s in range(S):
            for q, idx in zip(neighbors[s], mappings[s]):
                if q < s:
                    continue
                pos = list(neighbors[q]).index(s)
                pa.append(offsets[s] + np.asarray(idx, dtype=np.int64))
                pb.append(offsets[q] + np.asarray(mappings[q][pos],
                                                  dtype=np.int64))
        roots = uf_resolve(int(offsets[-1]),
                           np.concatenate(pa) if pa else np.zeros(0, np.int64),
                           np.concatenate(pb) if pb else np.zeros(0, np.int64))
        # owner = subdomain of the root slot (roots are minimal slot ids,
        # and slots are subdomain-major, so the root lives on the lowest
        # sharer — the reference's rank-order ownership)
        uniq, inverse = np.unique(roots, return_inverse=True)
        gids = []
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            gids.append(inverse[lo:hi].astype(np.int64))
        return gids, len(uniq)

    @staticmethod
    def distributed_csr(mats, gids, d_list, n_global):
        """Convert overlapping local matrices to a global 1D-row-block CSR
        (``Subdomain::distributedCSR``, HPDDM_subdomain.hpp:549-656):
        row i is contributed by owners weighted with the POU so the
        assembled operator equals sum_s R^T D_s A_s R_s."""
        import scipy.sparse as sp
        acc = sp.csr_matrix((n_global, n_global))
        for s, m in enumerate(mats):
            g = np.asarray(gids[s])
            n = m.n
            R = sp.csr_matrix((np.ones(n), (g, np.arange(n))),
                              shape=(n_global, n))
            D = sp.diags(np.asarray(d_list[s])[:n])
            acc = acc + R @ D @ m.scipy(expand=True) @ R.T
        return sp.csr_matrix(acc)

    def permute_host(self, v: np.ndarray, s: int) -> np.ndarray:
        """Permute a host-side length-n_loc[s] vector of subdomain s."""
        if not self.renumbered:
            return v
        order = np.asarray(self.perm[s])
        order = order[order < len(v)]
        return np.asarray(v)[order]

    # ------------------------------------------------------------------
    @property
    def row_mask(self) -> jax.Array:
        """(S, n_max) bool — valid (non-padded) rows."""
        return jnp.arange(self.n_max)[None, :] < self.n_loc[:, None]

    def zero_pad(self, x: jax.Array) -> jax.Array:
        """Zero out padded rows of a (S, n_max, ...) array."""
        mask = self.row_mask
        return jnp.where(mask.reshape(mask.shape + (1,) * (x.ndim - 2)), x, 0)
