"""Row-level exchange plan: 128-wide row gathers/scatters for the general path.

The general ``exchange`` (arbitrary decompositions, caller numbering) needs
two irregular memory ops per call: gather the interface values out of
x (S, n_max, mu) and scatter the merged values back. XLA lowers both at
*element* granularity.

Interface dofs cluster into contiguous runs (grid lines, mesh surfaces), so
the set of 128-wide rows they touch is tiny. This plan precomputes
(host, setup time) the touched rows of the flattened (S*n_max -> R x 128)
view and a static column->slot map; at runtime both directions become

    rows = x_view[touched]                  # R_t unique row gather
    vals = rows.flat[slot_pos]              # small-array gather
    ...partner reduction (parallel/ops.py)...
    new  = where(col_has_slot, merged.flat[slot_of], rows)
    x_view = x_view.at[touched].set(new)    # R_t unique, sorted row scatter

i.e. unique-index, sorted, row-granular memory ops instead of
element scatters. Opt-in (HPDDM_TPU_ROWPLAN=1); not measured on the GPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowPlan:
    """Static plan mapping interface slots to 128-wide rows of x.flat."""
    touched: jax.Array    # (R_t,) int32 sorted unique row ids of (R, 128)
    slot_of: jax.Array    # (R_t, 128) int32 flat slot (s*m_max+k) per lane;
    #                       sentinel = S*m_max where no slot writes the lane
    slot_pos: jax.Array   # (S*m_max,) int32 position of each slot in the
    #                       (R_t*128,) touched layout; invalid slots point
    #                       at R_t*128 (a zero pad)
    R: int = dataclasses.field(metadata=dict(static=True))
    n_slots: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def build(if_idx: np.ndarray, if_mask: np.ndarray,
              n_max: int) -> "RowPlan":
        S, m_max = if_idx.shape
        n_slots = S * m_max
        total = S * n_max
        R = -(-total // 128)
        flat = (np.arange(S)[:, None] * n_max
                + if_idx.astype(np.int64))          # (S, m_max)
        flat = np.where(if_mask, flat, np.int64(-1)).reshape(-1)
        valid = flat >= 0
        rows = flat[valid] // 128
        touched = np.unique(rows).astype(np.int32)
        row_rank = {int(r): i for i, r in enumerate(touched)}
        R_t = len(touched)
        slot_of = np.full((R_t, 128), n_slots, dtype=np.int32)
        slot_pos = np.full(n_slots, R_t * 128, dtype=np.int32)
        slots = np.nonzero(valid)[0]
        lanes = flat[valid] % 128
        for j, r, lane in zip(slots, rows, lanes):
            i = row_rank[int(r)]
            slot_of[i, lane] = j
            slot_pos[j] = i * 128 + lane
        return RowPlan(touched=jnp.asarray(touched),
                       slot_of=jnp.asarray(slot_of),
                       slot_pos=jnp.asarray(slot_pos),
                       R=R, n_slots=n_slots)


def gather_rows(plan: RowPlan, x: jax.Array):
    """x (S, n_max, mu) -> (rows (R_t, 128, mu), xf (R, 128, mu) view)."""
    S, n_max, mu = x.shape
    xf = x.reshape(S * n_max, mu)
    pad = plan.R * 128 - S * n_max
    if pad:
        xf = jnp.concatenate([xf, jnp.zeros((pad, mu), xf.dtype)])
    xf = xf.reshape(plan.R, 128, mu)
    rows = xf[plan.touched]
    return rows, xf


def slot_values(plan: RowPlan, rows: jax.Array, S: int,
                m_max: int) -> jax.Array:
    """Interface values per slot from gathered rows -> (S, m_max, mu)."""
    mu = rows.shape[-1]
    flat = rows.reshape(-1, mu)
    flat = jnp.concatenate([flat, jnp.zeros((1, mu), flat.dtype)])
    return flat[plan.slot_pos].reshape(S, m_max, mu)


def scatter_rows(plan: RowPlan, xf: jax.Array, rows: jax.Array,
                 merged: jax.Array, S: int, n_max: int) -> jax.Array:
    """Write merged slot values back; returns the updated (S, n_max, mu).

    xf, rows: from ``gather_rows``; merged: (S, m_max, mu) in slot order.
    Columns without a slot keep their x value.
    """
    mu = xf.shape[-1]
    mflat = merged.reshape(-1, mu)
    mflat = jnp.concatenate([mflat, jnp.zeros((1, mu), mflat.dtype)])
    # per-RHS 2-D gathers (K,)[(R_t,128)] keep the gather in its simplest
    # form
    upd = jnp.stack([mflat[:, c][plan.slot_of] for c in range(mu)], axis=-1)
    keep = (plan.slot_of == plan.n_slots)[:, :, None]
    new_rows = jnp.where(keep, rows, upd)
    new_rows = jax.lax.optimization_barrier(new_rows)
    xf = xf.at[plan.touched].set(new_rows, indices_are_sorted=True,
                                 unique_indices=True)
    out = xf.reshape(plan.R * 128, mu)[: S * n_max]
    return out.reshape(S, n_max, mu)
