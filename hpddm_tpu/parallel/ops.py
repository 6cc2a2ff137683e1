"""Runtime communication primitives (the ``exchange`` layer).

The reference's halo exchange is an additive reduction over duplicated
unknowns via MPI point-to-point (HPDDM_subdomain.hpp:115-130); dot products
weight by the partition of unity so overlapping dofs are not double-counted
(HPDDM_iterative.hpp:489-522). Here:

* ``exchange`` = interface gather -> scatter-add into an (n_if+1,) buffer ->
  optional ``lax.psum`` over the mesh axis -> gather back. One fused XLA
  program; deterministic reduction order.
* ``scaled_exchange`` = multiply by the POU first (``Schwarz::exchange``,
  HPDDM_schwarz.hpp:180-188) — this is what makes local solves "restricted".
* ``weighted_dot`` / ``weighted_norm_sq`` = POU-weighted reductions +
  ``psum``: the per-iteration world collectives of the Krylov loop.

All functions take ``axis_name=None`` (single-device batch: the whole S axis
is local, no collective needed) or the mesh axis name used inside
``shard_map`` (the S axis is split across devices; ``psum`` rides the
device interconnect).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

# Row-level exchange plan (parallel/rowplan.py) on the general path,
# opt-in via HPDDM_TPU_ROWPLAN=1: 128-wide row-granular gathers/scatters
# instead of element-granular ones. Not measured on the GPU; kept for A/B
# testing (ROADMAP D2).
_ROWPLAN_ENV = os.environ.get("HPDDM_TPU_ROWPLAN", "")


def _rowplan_enabled() -> bool:
    return _ROWPLAN_ENV == "1"

from hpddm_tpu.dtypes import conj
from hpddm_tpu.parallel.decomposition import Decomposition


def psum_if(x: jax.Array, axis_name: Optional[str]) -> jax.Array:
    """psum over the subdomain mesh axis if sharded, identity otherwise.

    ``axis_name`` may be a tuple of mesh axes (e.g. ``("host", "sub")``
    for a hierarchical 2-D mesh): psum/all_gather/pmax reduce over the
    product natively, in host-major order — matching the
    ``P(("host", "sub"))`` sharding linearization."""
    if axis_name is None:
        return x
    return lax.psum(x, axis_name)


def axis_size_of(axis_name) -> int:
    """Total device count over one mesh axis or a tuple of axes."""
    if isinstance(axis_name, (tuple, list)):
        out = 1
        for a in axis_name:
            out *= lax.axis_size(a)
        return out
    return lax.axis_size(axis_name)


def axis_index_of(axis_name):
    """Row-major linearized device index over one axis or a tuple.

    Matches the ordering of ``P(axis_name)`` shardings and of
    ``all_gather(..., axis_name, tiled=True)``."""
    if isinstance(axis_name, (tuple, list)):
        idx = 0
        for a in axis_name:
            idx = idx * lax.axis_size(a) + lax.axis_index(a)
        return idx
    return lax.axis_index(axis_name)


def device_shifts(sub_shifts, S_loc: int):
    """Distinct device offsets holding partners of any local subdomain.

    A partner at subdomain offset ``v`` of a subdomain s in a contiguous
    block of S_loc lands on device offset (s%S_loc + v) // S_loc, i.e. one
    of {v//S_loc, (v+S_loc-1)//S_loc}. Static: drives the ppermute perms.
    """
    out = set()
    for v in sub_shifts:
        out.add(v // S_loc)
        out.add(-((-v) // S_loc))
    return tuple(sorted(out))


def _ppermute_shift(x: jax.Array, d: int, axis_name) -> jax.Array:
    """Receive device (p + d)'s copy of x (wraps at the mesh edge; callers
    must never index wrapped rows — partner/validity masks guarantee it).

    On a hierarchical mesh (tuple ``axis_name``, e.g. ``("host", "sub")``)
    the shift is over the *linearized* index p = h * Ps + s: one ppermute
    along the fast inner axis plus carry resolution along the outer
    axis/axes — the inner hop stays on the fast tier while only boundary
    shards genuinely need the outer hop.  For any d the carry takes
    exactly two consecutive values (s + d mod Ps spans < 2 Ps), so two
    outer shifts and one per-shard select suffice."""
    if d == 0:
        return x
    if isinstance(axis_name, (tuple, list)):
        if len(axis_name) == 1:
            return _ppermute_shift(x, d, axis_name[0])
        outer, inner = axis_name[:-1], axis_name[-1]
        if len(outer) == 1:
            outer = outer[0]
        Pi = lax.axis_size(inner)
        di = d % Pi                                # inner shift in [0, Pi)
        q = (d - di) // Pi                         # outer base shift
        x_in = _ppermute_shift(x, di, inner)
        x_q = _ppermute_shift(x_in, q, outer)
        if di == 0:
            return x_q
        x_q1 = _ppermute_shift(x_in, q + 1, outer)
        carry = lax.axis_index(inner) + di >= Pi   # per-shard scalar
        return jnp.where(carry, x_q1, x_q)
    P = lax.axis_size(axis_name)
    perm = [((i + d) % P, i) for i in range(P)]
    return lax.ppermute(x, axis_name, perm)


def _interface_reduce(dec: Decomposition, vals: jax.Array,
                      axis_name: Optional[str]) -> jax.Array:
    """Sum interface contributions over all owners — scatter-free.

    vals: (S_loc, m_max, mu) gathered interface values (zero on invalid
    slots). Each slot's class members are precomputed (dec.partners), so
    the reduction is self + k_max partner *gathers*, no scatter.

    Sharded: partners live only on the statically-known neighbor devices
    (dec.sub_shifts), so the slab to gather from is the concatenation of
    |D| ppermute'd neighbor slabs — per-device comm volume O(|D| * local
    interface), independent of the total subdomain count (the reference's
    point-to-point halo, HPDDM_subdomain.hpp:115-130). Gathered values are
    bitwise those of the full-slab formulation, so batched == sharded
    results stay bitwise identical. Falls back to an all_gather when the
    neighbor structure is dense (|D| >= P - 1) or unknown.
    """
    mu = vals.shape[-1]
    sentinel = dec.S * dec.m_max
    if axis_name is None:
        flat = vals.reshape(-1, mu)
        flat = jnp.concatenate([flat, jnp.zeros((1, mu), dtype=flat.dtype)])
        pvals = flat[dec.partners]
        return vals + jnp.sum(pvals, axis=2)

    S_loc = vals.shape[0]
    P = dec.S // S_loc
    D = device_shifts(dec.sub_shifts, S_loc) if dec.sub_shifts else ()
    if not D or len([d for d in D if d]) >= P - 1:
        # dense/unknown neighbor graph: the full slab is optimal
        vals_all = jax.lax.all_gather(vals, axis_name, axis=0, tiled=True)
        flat = vals_all.reshape(-1, mu)
        flat = jnp.concatenate([flat,
                                jnp.zeros((1, mu), dtype=flat.dtype)])
        pvals = flat[dec.partners]
        return vals + jnp.sum(pvals, axis=2)

    block = S_loc * dec.m_max
    slabs = [_ppermute_shift(vals, d, axis_name).reshape(block, mu)
             for d in D]
    flat = jnp.concatenate(slabs + [jnp.zeros((1, mu), dtype=vals.dtype)])
    # remap global flat ids -> compact-slab positions
    g = dec.partners                                    # (S_loc, m_max, k)
    qdev = g // block
    off = g - qdev * block
    dshift = qdev - axis_index_of(axis_name)
    pos = jnp.zeros_like(g)
    for j, d in enumerate(D):
        pos = jnp.where(dshift == d, j, pos)
    idx = jnp.where(g == sentinel, len(D) * block, pos * block + off)
    pvals = flat[idx]
    return vals + jnp.sum(pvals, axis=2)


def exchange(dec: Decomposition, x: jax.Array,
             axis_name: Optional[str] = None) -> jax.Array:
    """Sum-reduce duplicated unknowns (``Subdomain::exchange``).

    x: (S_loc, n_max, mu). After the call, every copy of a shared dof holds
    the sum of all copies; interior dofs are untouched.

    Fast path (interface-first renumbered decompositions, the default):
    the interface block is the contiguous slice x[:, :m_max] — one static
    slice, k_max partner gathers on the small slab, one contiguous write-
    back. Slots of subdomains with fewer interface dofs than m_max carry
    interior values whose partner lists are empty (sentinel), so they pass
    through unchanged. No full-vector gather or scatter anywhere.
    """
    if dec.grid is not None and not dec.renumbered:
        from hpddm_tpu.parallel.grid import grid_exchange
        return grid_exchange(dec.grid, x, axis_name)
    if dec.renumbered:
        m = dec.m_max
        vals = x[:, :m, :]
        summed = _interface_reduce(dec, vals, axis_name)
        return jnp.concatenate([summed, x[:, m:, :]], axis=1)
    if (dec.rowplan is not None and axis_name is None
            and x.shape[0] * dec.m_max == dec.rowplan.n_slots
            and _rowplan_enabled()):
        # general path, row-level plan (full batch only): unique sorted
        # 128-wide row gathers/scatters instead of element-granular ones
        from hpddm_tpu.parallel import rowplan as rp
        plan = dec.rowplan
        rows, xf = rp.gather_rows(plan, x)
        # barriers: keep the row gather / slot gather / row scatter as
        # separate XLA fusions
        rows, xf = lax.optimization_barrier((rows, xf))
        vals = rp.slot_values(plan, rows, x.shape[0], dec.m_max)
        vals = lax.optimization_barrier(vals)
        summed = _interface_reduce(dec, vals, axis_name)
        summed = lax.optimization_barrier(summed)
        return rp.scatter_rows(plan, xf, rows, summed, x.shape[0],
                               dec.n_max)
    # general path (caller numbering kept): scatter the summed slots back
    vals = jnp.take_along_axis(x, dec.if_idx[:, :, None], axis=1)
    vals = jnp.where(dec.if_mask[:, :, None], vals, 0)
    summed = _interface_reduce(dec, vals, axis_name)
    return _scatter_rows(x, dec.if_idx, dec.if_mask, summed)


def scaled_exchange(dec: Decomposition, x: jax.Array,
                    axis_name: Optional[str] = None) -> jax.Array:
    """``Schwarz::exchange``: multiply by the POU then sum-reduce.

    For a consistent input this is the identity (sum_q R_q^T D_q R_q = I).
    """
    return exchange(dec, dec.d[:, :, None] * x, axis_name)


def _scatter_rows(x: jax.Array, idx: jax.Array, mask: jax.Array,
                  vals: jax.Array) -> jax.Array:
    """x[s, idx[s, k], :] = vals[s, k, :] where mask[s, k].

    Invalid slots point at row 0 with their original gathered value, so the
    unconditional scatter is still correct as long as duplicate slots carry
    identical values — which `exchange` guarantees (idx 0 appears at most
    once per row among valid slots; invalid slots all write the *gathered*
    value of row 0 back... To stay safe we scatter with explicit select).
    """
    S, m = idx.shape
    s_idx = jnp.broadcast_to(jnp.arange(S)[:, None], (S, m))
    safe_idx = jnp.where(mask, idx, x.shape[1])  # out-of-bounds -> dropped
    return x.at[s_idx, safe_idx].set(vals, mode="drop")


def weighted_dot(dec: Decomposition, x: jax.Array, y: jax.Array,
                 axis_name: Optional[str] = None) -> jax.Array:
    """POU-weighted global dot per RHS: sum_s sum_i d[s,i] conj(x) y -> (mu,)."""
    local = jnp.sum(dec.d[:, :, None] * conj(x) * y, axis=(0, 1))
    return psum_if(local, axis_name)


def weighted_norm_sq(dec: Decomposition, x: jax.Array,
                     axis_name: Optional[str] = None) -> jax.Array:
    """POU-weighted squared norm per RHS -> (mu,) real."""
    local = jnp.sum(dec.d[:, :, None] * jnp.abs(x) ** 2, axis=(0, 1))
    return psum_if(local, axis_name)


def weighted_gram(dec: Decomposition, V: jax.Array, y: jax.Array,
                  axis_name: Optional[str] = None) -> jax.Array:
    """Batch of weighted dots against a basis: V (k, S, n, mu), y (S, n, mu)
    -> (k, mu). The CGS single-allreduce Gram vector
    (HPDDM_iterative.hpp:489-522)."""
    local = jnp.einsum("ksnm,snm->km", conj(V), dec.d[None, :, :, None] * y)
    return psum_if(local, axis_name)
