"""Structured-grid halo exchange: the scatter-free fast path.

The general ``exchange`` (parallel/ops.py) must handle arbitrary
decompositions, which costs three irregular row operations per call
(interface gather, partner-slab gather, scatter-back). For 2D grid
decompositions with *uniform* boxes (models/diffusion2d
``uniform_boxes=True``), the duplicated unknowns are exactly the
box-boundary strips, so the whole reduction is expressible with static
slices, eight S-axis row gathers (contiguous, regular), and adds —
nothing irregular anywhere. This is the analogue of the
reference's ``Subdomain::exchange`` point-to-point halo swap
(HPDDM_subdomain.hpp:115-130) specialized the way distributed stencil
codes do it on device meshes.

Neighbor strips are padded to width ``t = 3*overlap`` (edge boxes are
extended inward to stay uniform, which widens their shared region to
3*overlap; interior pairs share 2*overlap) and re-aligned per subdomain
with a cheap narrow take_along_axis. When sharded on a *regular* process
grid, each of the 8 neighbor directions is a static flat shift of the S
axis resolved with two ``ppermute``s — point-to-point with neighbor
devices only, per-device comm volume independent of the total subdomain
count (the reference's halo swap, HPDDM_subdomain.hpp:115-130).
Irregular grids fall back to all_gathered strips + one-hot selection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# direction order: E, W, N, S, NE, NW, SE, SW
_DIRS = ((0, 1), (0, -1), (-1, 0), (1, 0), (-1, 1), (-1, -1), (1, 1), (1, -1))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static halo-exchange plan for a uniform-box 2D grid decomposition."""
    nbr: jax.Array    # (S, 8) int32 neighbor subdomain id; sentinel = S
    sxw: jax.Array    # (S, 8) int32 shared width along x with that neighbor
    syw: jax.Array    # (S, 8) int32 shared width along y
    # (S, 8, S+1) one-hot of nbr: the S-axis neighbor "gather" is done as
    # a (S, S+1) x (S+1, strip) matmul. S-leading so shard_map splits it
    # alongside the subdomain axis.
    onehot: jax.Array
    H: int = dataclasses.field(metadata=dict(static=True))
    W: int = dataclasses.field(metadata=dict(static=True))
    t: int = dataclasses.field(metadata=dict(static=True))
    S: int = dataclasses.field(metadata=dict(static=True))
    # regular row-major process grid (s == iy*gx + ix): neighbor selection
    # becomes a *static shift* of the (gy, gx, ...) strip tensor — no
    # matmul, no gather
    gx: int = dataclasses.field(default=0, metadata=dict(static=True))
    gy: int = dataclasses.field(default=0, metadata=dict(static=True))
    regular: bool = dataclasses.field(default=False,
                                      metadata=dict(static=True))
    # static copies of sxw/syw (tuple[dir][s]): the alignment shifts are
    # decomposition constants taking only 2-3 distinct values, so the
    # realign select collapses to that many *static* shifts + masks
    # instead of 2t+1 traced variants (fewer small ops per exchange)
    sxw_s: tuple = dataclasses.field(default=None,
                                     metadata=dict(static=True))
    syw_s: tuple = dataclasses.field(default=None,
                                     metadata=dict(static=True))


def build_grid_plan(boxes) -> Optional[GridPlan]:
    """Build a plan from subdomain boxes; None if the decomposition is not
    a uniform-box aligned grid (the general exchange handles it instead).
    The strip width t is the widest pair overlap (2*overlap for interior
    pairs, 3*overlap where edge boxes were extended inward)."""
    S = len(boxes)
    ws = {(i1 - i0, j1 - j0) for (i0, i1, j0, j1) in boxes}
    if len(ws) != 1:
        return None
    (W, H), = ws
    # recover the process grid from box origins
    xs = sorted({b[0] for b in boxes})
    ys = sorted({b[2] for b in boxes})
    if len(xs) * len(ys) != S:
        return None
    # only adjacent grid cells may overlap (otherwise strips can't cover)
    if any(xs[i + 2] < xs[i] + W for i in range(len(xs) - 2)):
        return None
    if any(ys[i + 2] < ys[i] + H for i in range(len(ys) - 2)):
        return None
    pos = {(b[2], b[0]): s for s, b in enumerate(boxes)}
    gx = {x: ix for ix, x in enumerate(xs)}
    gy = {y: iy for iy, y in enumerate(ys)}
    t = 0
    for i in range(len(xs) - 1):
        t = max(t, xs[i] + W - xs[i + 1])
    for i in range(len(ys) - 1):
        t = max(t, ys[i] + H - ys[i + 1])
    if t <= 0 or W <= t or H <= t:
        return None
    nbr = np.full((S, 8), S, dtype=np.int32)
    sxw = np.zeros((S, 8), dtype=np.int32)
    syw = np.zeros((S, 8), dtype=np.int32)
    for s, (i0, i1, j0, j1) in enumerate(boxes):
        ix, iy = gx[i0], gy[j0]
        for dir_, (dy, dx) in enumerate(_DIRS):
            jx, jy = ix + dx, iy + dy
            if not (0 <= jx < len(xs) and 0 <= jy < len(ys)):
                continue
            q = pos[(ys[jy], xs[jx])]
            qi0, qi1, qj0, qj1 = boxes[q]
            ox = min(i1, qi1) - max(i0, qi0)      # shared extent along x
            oy = min(j1, qj1) - max(j0, qj0)
            if ox <= 0 or oy <= 0:
                continue
            nbr[s, dir_] = q
            sxw[s, dir_] = ox if dx else W
            syw[s, dir_] = oy if dy else H
    onehot = np.zeros((S, 8, S + 1), dtype=np.float32)
    for dir_ in range(8):
        onehot[np.arange(S), dir_, nbr[:, dir_]] = 1.0
    gx_n, gy_n = len(xs), len(ys)
    regular = all(pos.get((ys[iy], xs[ix])) == iy * gx_n + ix
                  for iy in range(gy_n) for ix in range(gx_n))
    return GridPlan(nbr=jnp.asarray(nbr), sxw=jnp.asarray(sxw),
                    syw=jnp.asarray(syw), onehot=jnp.asarray(onehot),
                    H=H, W=W, t=t, S=S,
                    gx=gx_n, gy=gy_n, regular=regular,
                    sxw_s=tuple(map(tuple, sxw.T.tolist())),
                    syw_s=tuple(map(tuple, syw.T.tolist())))


def _static_shift(vals: jax.Array, v: int, axis: int) -> jax.Array:
    """out[..., i, ...] = vals[..., i+v, ...], zero-filled (static v)."""
    if v == 0:
        return vals
    ext = vals.shape[axis]
    idx = [slice(None)] * vals.ndim
    pad = [(0, 0)] * vals.ndim
    if v > 0:
        idx[axis] = slice(min(v, ext), ext)
        pad[axis] = (0, min(v, ext))
    else:
        idx[axis] = slice(0, max(ext + v, 0))
        pad[axis] = (min(-v, ext), 0)
    return jnp.pad(vals[tuple(idx)], pad)


def _global_row_shift(x: jax.Array, k: int, axis_name: str) -> jax.Array:
    """out[i] = x_global[p*S_loc + i + k] for the flattened-S sharded axis.

    The needed rows span at most two neighbor devices (static shifts
    k//S_loc and k//S_loc + 1), so this is two ppermutes of complementary
    row slices — per-device volume exactly one slab, independent of the
    total subdomain count. Rows whose global source is out of range carry
    wrapped garbage; callers mask them (the grid-validity mask covers
    exactly those rows, see _sharded_neighbor_take)."""
    from hpddm_tpu.parallel.ops import _ppermute_shift
    S_loc = x.shape[0]
    d1, r = divmod(k, S_loc)
    a = _ppermute_shift(x[r:], d1, axis_name)
    if r == 0:
        return a
    b = _ppermute_shift(x[:r], d1 + 1, axis_name)
    return jnp.concatenate([a, b], axis=0)


def _sharded_neighbor_take(plan: "GridPlan", axis_name: str, S_loc: int):
    """Neighbor strip selection on *local* strips under shard_map: the
    analogue of the reference's point-to-point halo swap
    (HPDDM_subdomain.hpp:115-130). On a regular row-major process grid the
    8 neighbor directions are static flat shifts dy*gx + dx of the S axis,
    each resolved with two ppermutes (no all_gather: per-device comm is
    O(local perimeter)). Values are bitwise those of the gathered-slab
    formulation, keeping batched == sharded exact."""
    from hpddm_tpu.parallel.ops import axis_index_of
    p = axis_index_of(axis_name)
    g = p * S_loc + jnp.arange(S_loc)
    iy, ix = g // plan.gx, g % plan.gx

    def take(strips, dir_):
        dy, dx = _DIRS[dir_]
        out = _global_row_shift(strips, dy * plan.gx + dx, axis_name)
        ok = ((iy + dy >= 0) & (iy + dy < plan.gy) &
              (ix + dx >= 0) & (ix + dx < plan.gx))
        return jnp.where(ok.reshape((S_loc,) + (1,) * (strips.ndim - 1)),
                         out, 0)

    return take


def _shift_select(vals: jax.Array, k: jax.Array, axis: int,
                  t: int) -> jax.Array:
    """out[s, ..., i, ...] = vals[s, ..., i + k[s], ...], zero outside.

    k: (S,) per-subdomain shift in [-t, t]. Computed as a select over the
    2t+1 statically-shifted variants — elementwise, no gathers."""
    variants = jnp.stack([_static_shift(vals, v, axis)
                          for v in range(-t, t + 1)])      # (2t+1, S, ...)
    sel = (k + t)[None, :] == jnp.arange(2 * t + 1)[:, None]
    sel = sel.reshape(sel.shape + (1,) * (vals.ndim - 1))
    return jnp.sum(jnp.where(sel, variants, 0), axis=0)


def _shift_select_static(vals: jax.Array, k_np: np.ndarray, axis: int,
                         s_off: int) -> jax.Array:
    """``_shift_select`` with *static* per-subdomain shifts: one static
    shift (+ static mask when several values coexist) per distinct value —
    typically 2-3 ops instead of 2t+1 traced variants.

    k_np: (S_total,) host ints; s_off: first global subdomain of this
    shard (vals has S_loc leading rows starting there)."""
    S_loc = vals.shape[0]
    k_loc = np.asarray(k_np[s_off: s_off + S_loc])
    distinct = sorted(set(k_loc.tolist()))
    if len(distinct) == 1:
        return _static_shift(vals, int(distinct[0]), axis)
    out = None
    for v in distinct:
        mask = jnp.asarray(k_loc == v).reshape(
            (S_loc,) + (1,) * (vals.ndim - 1))
        term = jnp.where(mask, _static_shift(vals, int(v), axis), 0)
        out = term if out is None else out + term
    return out


import os

# composition of the final canvas update (A/B-switchable for measurement;
# none of the three is measured on the GPU yet, ROADMAP D2):
# "hybrid" = row-band concat + column-padded E/W adds fused into the mid
#   pass;
# "band" = row-band concat with *column* concats for E/W;
# "pad" = four zero-padded full-canvas strip adds.
_COMPOSE = os.environ.get("HPDDM_TPU_GRID_COMPOSE", "hybrid")


def grid_exchange(plan: GridPlan, x: jax.Array,
                  axis_name: Optional[str] = None) -> jax.Array:
    """Sum-reduce duplicated unknowns on a uniform grid decomposition.

    Runs on a (S, H, W*mu) canvas: merging the RHS axis into the minor
    dimension keeps the contiguous axis running across W — the rank-4
    (S, H, W, mu) form puts the size-mu axis minor."""
    if os.environ.get("HPDDM_TPU_GRID_LAYOUT") == "4d":
        return _grid_exchange_4d(plan, x, axis_name)
    S_loc, n_max, mu = x.shape
    if mu > 1 and os.environ.get("HPDDM_TPU_GRID_MU") != "merged":
        # multi-RHS: vmap the single-RHS exchange over a *leading* mu
        # axis. The merged-minor form below keeps mu in the minor
        # dimension, where every canvas op relayouts the (.., W*mu)
        # canvas; the leading-batch form keeps W minor and costs mu x
        # the mu=1 ops plus two leading-axis transposes.
        xT = jnp.moveaxis(x, 2, 0)                      # (mu, S, n)
        outT = jax.vmap(
            lambda v: grid_exchange(plan, v[:, :, None], axis_name)[:, :, 0]
        )(xT)
        return jnp.moveaxis(outT, 0, 2)
    H, W, t = plan.H, plan.W, plan.t
    Wm, tm = W * mu, t * mu
    x4 = x[:, : H * W, :].reshape(S_loc, H, Wm)

    Est = x4[:, :, Wm - tm:]
    Wst = x4[:, :, :tm]
    Nst = x4[:, :t, :]
    Sst = x4[:, H - t:, :]
    if axis_name is not None and not plan.regular:
        Est = lax.all_gather(Est, axis_name, axis=0, tiled=True)
        Wst = lax.all_gather(Wst, axis_name, axis=0, tiled=True)
        Nst = lax.all_gather(Nst, axis_name, axis=0, tiled=True)
        Sst = lax.all_gather(Sst, axis_name, axis=0, tiled=True)

    sxw, syw = plan.sxw, plan.syw

    if plan.regular:
        if axis_name is not None:
            take = _sharded_neighbor_take(plan, axis_name, S_loc)
        else:
            def take(strips, dir_):
                dy, dx = _DIRS[dir_]
                g = strips.reshape((plan.gy, plan.gx) + strips.shape[1:])
                g = _static_shift(_static_shift(g, dy, 0), dx, 1)
                return g.reshape(strips.shape)
        Ep, Wp, Np, Sp = Est, Wst, Nst, Sst
    else:
        def pad(strip):
            z = jnp.zeros((1,) + strip.shape[1:], strip.dtype)
            return jnp.concatenate([strip, z], axis=0)

        Ep, Wp, Np, Sp = pad(Est), pad(Wst), pad(Nst), pad(Sst)
        oh = plan.onehot.astype(x.dtype)

        def take(strips_p, dir_):
            return jnp.einsum("sq,qab->sab", oh[:, dir_, :], strips_p)

    use_static = plan.sxw_s is not None and S_loc == plan.S
    if use_static:
        sxw_d = lambda d: np.asarray(plan.sxw_s[d])
        syw_d = lambda d: np.asarray(plan.syw_s[d])

        def selx(vals, k):      # x shifts act on the merged axis, scaled
            return _shift_select_static(vals, np.asarray(k) * mu, 2, 0)

        def sely(vals, k):
            return _shift_select_static(vals, k, 1, 0)
    else:
        sxw_d = lambda d: sxw[:, d]
        syw_d = lambda d: syw[:, d]

        def selx(vals, k):
            return _shift_select_mu(vals, k, 2, t, mu)

        def sely(vals, k):
            return _shift_select(vals, k, 1, t)

    def lo(shared):
        return t - shared

    def hi(shared):
        return shared - t

    e = selx(take(Wp, 0), hi(sxw_d(0)))
    w = selx(take(Ep, 1), lo(sxw_d(1)))
    n = sely(take(Sp, 2), lo(syw_d(2)))
    s = sely(take(Np, 3), hi(syw_d(3)))
    ne = selx(sely(take(Sp, 4)[:, :, :tm], lo(syw_d(4))), hi(sxw_d(4)))
    nw = selx(sely(take(Sp, 5)[:, :, Wm - tm:], lo(syw_d(5))), lo(sxw_d(5)))
    se = selx(sely(take(Np, 6)[:, :, :tm], hi(syw_d(6))), hi(sxw_d(6)))
    sw = selx(sely(take(Np, 7)[:, :, Wm - tm:], hi(syw_d(7))), lo(sxw_d(7)))

    if _COMPOSE == "hybrid":
        # corners + edge E/W segments into the full-width N/S strips (thin)
        n = (n.at[:, :, Wm - tm:].add(ne + e[:, :t, :])
              .at[:, :, :tm].add(nw + w[:, :t, :]))
        s = (s.at[:, :, Wm - tm:].add(se + e[:, H - t:, :])
              .at[:, :, :tm].add(sw + w[:, H - t:, :]))
        # mid rows: column-padded E/W adds fuse into one elementwise pass
        # (a column concat here would relayout the whole canvas)
        mid = (x4[:, t:H - t, :]
               + jnp.pad(w[:, t:H - t, :], [(0, 0), (0, 0), (0, Wm - tm)])
               + jnp.pad(e[:, t:H - t, :], [(0, 0), (0, 0), (Wm - tm, 0)]))
        x4 = jnp.concatenate([
            x4[:, :t, :] + n, mid, x4[:, H - t:, :] + s], axis=1)
    elif _COMPOSE == "band":
        n = (n.at[:, :, Wm - tm:].add(ne + e[:, :t, :])
              .at[:, :, :tm].add(nw + w[:, :t, :]))
        s = (s.at[:, :, Wm - tm:].add(se + e[:, H - t:, :])
              .at[:, :, :tm].add(sw + w[:, H - t:, :]))
        mid = jnp.concatenate([
            x4[:, t:H - t, :tm] + w[:, t:H - t, :],
            x4[:, t:H - t, tm:Wm - tm],
            x4[:, t:H - t, Wm - tm:] + e[:, t:H - t, :]], axis=2)
        x4 = jnp.concatenate([
            x4[:, :t, :] + n, mid, x4[:, H - t:, :] + s], axis=1)
    else:
        e = e.at[:, :t, :].add(ne).at[:, H - t:, :].add(se)
        w = w.at[:, :t, :].add(nw).at[:, H - t:, :].add(sw)
        x4 = (x4
              + jnp.pad(e, [(0, 0), (0, 0), (Wm - tm, 0)])
              + jnp.pad(w, [(0, 0), (0, 0), (0, Wm - tm)])
              + jnp.pad(n, [(0, 0), (0, H - t), (0, 0)])
              + jnp.pad(s, [(0, 0), (H - t, 0), (0, 0)]))

    out = x4.reshape(S_loc, H * W, mu)
    if n_max > H * W:
        out = jnp.concatenate([out, x[:, H * W:, :]], axis=1)
    return out


def grid_exchange_muT(plan: GridPlan, xT: jax.Array,
                      axis_name: Optional[str] = None) -> jax.Array:
    """Multi-RHS grid exchange with the RHS axis leading:
    (S, mu, n) -> (S, mu, n); each RHS runs the single-RHS exchange
    (vmapped over axis 1 — canvas W stays the minor dimension)."""
    return jax.vmap(
        lambda v: grid_exchange(plan, v[:, :, None], axis_name)[:, :, 0],
        in_axes=1, out_axes=1)(xT)


def grid_exchange_muT_scan(plan: GridPlan, xT: jax.Array,
                           axis_name: Optional[str] = None) -> jax.Array:
    """muT grid exchange as a ``lax.scan`` over single RHS.

    The vmapped form above batches every canvas op over a leading mu axis,
    and XLA may re-tile the batched shift/select chains so the per-RHS
    cost grows with mu.  A scan body is the plain mu=1 exchange; the carry is
    updated in place (donated buffer), so the only extra traffic is the
    unavoidable read+write of x itself."""
    S, mu, n = xT.shape
    if mu == 1:
        return grid_exchange_muT(plan, xT, axis_name)

    def body(y, g):
        xm = lax.dynamic_slice_in_dim(xT, g, 1, axis=1)
        ym = grid_exchange(plan, xm.reshape(S, n, 1), axis_name)
        return lax.dynamic_update_slice_in_dim(
            y, ym.reshape(S, 1, n), g, axis=1), None

    y0 = jnp.zeros_like(xT)
    y, _ = lax.scan(body, y0, jnp.arange(mu))
    return y


def _shift_select_mu(vals: jax.Array, k: jax.Array, axis: int, t: int,
                     mu: int) -> jax.Array:
    """Traced ``_shift_select`` on a mu-merged axis: shift k[s]*mu."""
    variants = jnp.stack([_static_shift(vals, v * mu, axis)
                          for v in range(-t, t + 1)])
    sel = (k + t)[None, :] == jnp.arange(2 * t + 1)[:, None]
    sel = sel.reshape(sel.shape + (1,) * (vals.ndim - 1))
    return jnp.sum(jnp.where(sel, variants, 0), axis=0)


def _grid_exchange_4d(plan: GridPlan, x: jax.Array,
                      axis_name: Optional[str] = None) -> jax.Array:
    """Rank-4 formulation (A/B: HPDDM_TPU_GRID_LAYOUT=4d)."""
    S_loc, n_max, mu = x.shape
    H, W, t = plan.H, plan.W, plan.t
    x4 = x[:, : H * W, :].reshape(S_loc, H, W, mu)

    Est = x4[:, :, W - t:, :]
    Wst = x4[:, :, :t, :]
    Nst = x4[:, :t, :, :]
    Sst = x4[:, H - t:, :, :]
    if axis_name is not None and not plan.regular:
        Est = lax.all_gather(Est, axis_name, axis=0, tiled=True)
        Wst = lax.all_gather(Wst, axis_name, axis=0, tiled=True)
        Nst = lax.all_gather(Nst, axis_name, axis=0, tiled=True)
        Sst = lax.all_gather(Sst, axis_name, axis=0, tiled=True)

    sxw, syw = plan.sxw, plan.syw

    if plan.regular:
        if axis_name is not None:
            take = _sharded_neighbor_take(plan, axis_name, S_loc)
        else:
            # neighbor selection = static shift of the (gy, gx, ...) tensor
            def take(strips, dir_):
                dy, dx = _DIRS[dir_]
                g = strips.reshape((plan.gy, plan.gx) + strips.shape[1:])
                g = _static_shift(_static_shift(g, dy, 0), dx, 1)
                return g.reshape(strips.shape)
        Ep, Wp, Np, Sp = Est, Wst, Nst, Sst
    else:
        def pad(strip):
            z = jnp.zeros((1,) + strip.shape[1:], strip.dtype)
            return jnp.concatenate([strip, z], axis=0)

        Ep, Wp, Np, Sp = pad(Est), pad(Wst), pad(Nst), pad(Sst)
        oh = plan.onehot.astype(x.dtype)

        def take(strips_p, dir_):
            # neighbor "gather" as a one-hot matmul (no generic gather)
            return jnp.einsum("sq,qabm->sabm", oh[:, dir_, :], strips_p)

    # realign selects: the shifts are decomposition constants, so when the
    # shard covers the full plan they collapse to 2-3 *static* shifts with
    # static masks (fewer small ops); sharded
    # slices keep the traced 2t+1-variant select
    use_static = plan.sxw_s is not None and S_loc == plan.S
    if use_static:
        sxw_d = lambda d: np.asarray(plan.sxw_s[d])
        syw_d = lambda d: np.asarray(plan.syw_s[d])
        sel = lambda vals, k, axis: _shift_select_static(vals, k, axis, 0)
    else:
        sxw_d = lambda d: sxw[:, d]
        syw_d = lambda d: syw[:, d]
        sel = lambda vals, k, axis: _shift_select(vals, k, axis, t)

    def lo(shared):            # my strip rows/cols [0, t): shift by t-shared
        return t - shared
    def hi(shared):
        return shared - t

    # cardinal contributions
    e = sel(take(Wp, 0), hi(sxw_d(0)), 2)
    w = sel(take(Ep, 1), lo(sxw_d(1)), 2)
    n = sel(take(Sp, 2), lo(syw_d(2)), 1)
    s = sel(take(Np, 3), hi(syw_d(3)), 1)
    # diagonal corner tiles (sliced out of the neighbor's strip tensors)
    ne = sel(sel(take(Sp, 4)[:, :, :t, :], lo(syw_d(4)), 1), hi(sxw_d(4)), 2)
    nw = sel(sel(take(Sp, 5)[:, :, W - t:, :],
                 lo(syw_d(5)), 1), lo(sxw_d(5)), 2)
    se = sel(sel(take(Np, 6)[:, :, :t, :], hi(syw_d(6)), 1), hi(sxw_d(6)), 2)
    sw = sel(sel(take(Np, 7)[:, :, W - t:, :],
                 hi(syw_d(7)), 1), lo(sxw_d(7)), 2)

    if _COMPOSE == "band":
        # Row-band concat: corner tiles and the E/W strips' corner rows
        # fold into the full-width N/S strips (tiny (S, t, W) ops), then
        # one fused pass assembles the three bands.
        n = (n.at[:, :, W - t:, :].add(ne + e[:, :t, :, :])
              .at[:, :, :t, :].add(nw + w[:, :t, :, :]))
        s = (s.at[:, :, W - t:, :].add(se + e[:, H - t:, :, :])
              .at[:, :, :t, :].add(sw + w[:, H - t:, :, :]))
        mid = jnp.concatenate([
            x4[:, t:H - t, :t, :] + w[:, t:H - t, :, :],
            x4[:, t:H - t, t:W - t, :],
            x4[:, t:H - t, W - t:, :] + e[:, t:H - t, :, :]], axis=2)
        x4 = jnp.concatenate([
            x4[:, :t, :, :] + n, mid, x4[:, H - t:, :, :] + s], axis=1)
    else:
        # zero-padded strip adds (round-1 formulation)
        e = e.at[:, :t, :, :].add(ne).at[:, H - t:, :, :].add(se)
        w = w.at[:, :t, :, :].add(nw).at[:, H - t:, :, :].add(sw)
        x4 = (x4
              + jnp.pad(e, [(0, 0), (0, 0), (W - t, 0), (0, 0)])
              + jnp.pad(w, [(0, 0), (0, 0), (0, W - t), (0, 0)])
              + jnp.pad(n, [(0, 0), (0, H - t), (0, 0), (0, 0)])
              + jnp.pad(s, [(0, 0), (H - t, 0), (0, 0), (0, 0)]))

    out = x4.reshape(S_loc, H * W, mu)
    if n_max > H * W:
        out = jnp.concatenate([out, x[:, H * W:, :]], axis=1)
    return out
