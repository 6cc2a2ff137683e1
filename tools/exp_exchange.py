#!/usr/bin/env python
"""Decompose the grid-exchange step cost: strip phase (takes + realigns)
vs compose phase (band concat / full-canvas copy). Length-differenced: two
scan lengths per call cancel the fixed per-call overhead."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def timed(fn, x, length, reps=5):
    import jax
    from jax import lax

    @jax.jit
    def chain(v):
        out, _ = lax.scan(lambda c, _: (fn(c), None), v, None, length=length)
        return out

    y = chain(x)
    _fetch_sync(y)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        y = chain(y)
        _fetch_sync(y)
        best = min(best, time.perf_counter() - t0)
    return best


def step_us(fn, x, L1=10, L2=110):
    w1 = timed(fn, x, L1)
    w2 = timed(fn, x, L2)
    return (w2 - w1) / (L2 - L1) * 1e6


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.parallel import grid as G
    from hpddm_tpu.parallel.ops import scaled_exchange
    from hpddm_tpu.precond.schwarz import Schwarz, gmv

    argv = [int(a) for a in sys.argv[1:4]] or [16, 2048, 2048]
    S, Nx, Ny = argv
    dtype = np.float32
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, dtype=dtype)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.operator_state()
    dec = state.dec
    plan = dec.grid
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)).astype(dtype))

    H, W, t = plan.H, plan.W, plan.t

    def strips_only(v):
        # all takes + realigns, result folded to keep shapes (no compose)
        S_loc, n_max, mu = v.shape
        Wm, tm = W * mu, t * mu
        x4 = v[:, : H * W, :].reshape(S_loc, H, Wm)
        Est = x4[:, :, Wm - tm:]
        Wst = x4[:, :, :tm]
        Nst = x4[:, :t, :]
        Sst = x4[:, H - t:, :]

        def take(strips, dir_):
            dy, dx = G._DIRS[dir_]
            g = strips.reshape((plan.gy, plan.gx) + strips.shape[1:])
            g = G._static_shift(G._static_shift(g, dy, 0), dx, 1)
            return g.reshape(strips.shape)

        selx = lambda vals, k: G._shift_select_static(
            vals, np.asarray(k) * mu, 2, 0)
        sely = lambda vals, k: G._shift_select_static(vals, np.asarray(k), 1, 0)
        sxw_d = lambda d: np.asarray(plan.sxw_s[d])
        syw_d = lambda d: np.asarray(plan.syw_s[d])
        lo = lambda sh: t - sh
        hi = lambda sh: sh - t
        e = selx(take(Wst, 0), hi(sxw_d(0)))
        w = selx(take(Est, 1), lo(sxw_d(1)))
        n = sely(take(Sst, 2), lo(syw_d(2)))
        s = sely(take(Nst, 3), hi(syw_d(3)))
        ne = selx(sely(take(Sst, 4)[:, :, :tm], lo(syw_d(4))), hi(sxw_d(4)))
        nw = selx(sely(take(Sst, 5)[:, :, Wm - tm:], lo(syw_d(5))),
                  lo(sxw_d(5)))
        se = selx(sely(take(Nst, 6)[:, :, :tm], hi(syw_d(6))), hi(sxw_d(6)))
        sw = selx(sely(take(Nst, 7)[:, :, Wm - tm:], hi(syw_d(7))),
                  lo(sxw_d(7)))
        # fold the strips back into v's edges only (thin adds, no copy)
        x4 = (x4.at[:, :, Wm - tm:].add(e).at[:, :, :tm].add(w)
                .at[:, :t, :].add(n).at[:, H - t:, :].add(s)
                .at[:, :t, Wm - tm:].add(ne).at[:, :t, :tm].add(nw)
                .at[:, H - t:, Wm - tm:].add(se)
                .at[:, H - t:, :tm].add(sw))
        out = x4.reshape(S_loc, H * W, mu)
        if n_max > H * W:
            out = jnp.concatenate([out, v[:, H * W:, :]], axis=1)
        return out

    def copy_only(v):
        # compose phase alone: band concat of slices (no strips)
        S_loc, n_max, mu = v.shape
        Wm, tm = W * mu, t * mu
        x4 = v[:, : H * W, :].reshape(S_loc, H, Wm)
        mid = jnp.concatenate([
            x4[:, t:H - t, :tm] * 2.0,
            x4[:, t:H - t, tm:Wm - tm],
            x4[:, t:H - t, Wm - tm:] * 2.0], axis=2)
        x4 = jnp.concatenate([x4[:, :t, :] * 2.0, mid,
                              x4[:, H - t:, :] * 2.0], axis=1)
        out = x4.reshape(S_loc, H * W, mu)
        if n_max > H * W:
            out = jnp.concatenate([out, v[:, H * W:, :]], axis=1)
        return out

    def _strips(v):
        S_loc, n_max, mu = v.shape
        Wm, tm = W * mu, t * mu
        x4 = v[:, : H * W, :].reshape(S_loc, H, Wm)
        Est = x4[:, :, Wm - tm:]
        Wst = x4[:, :, :tm]
        Nst = x4[:, :t, :]
        Sst = x4[:, H - t:, :]

        def take(strips, dir_):
            dy, dx = G._DIRS[dir_]
            g = strips.reshape((plan.gy, plan.gx) + strips.shape[1:])
            g = G._static_shift(G._static_shift(g, dy, 0), dx, 1)
            return g.reshape(strips.shape)

        selx = lambda vals, k: G._shift_select_static(
            vals, np.asarray(k) * mu, 2, 0)
        sely = lambda vals, k: G._shift_select_static(vals, np.asarray(k),
                                                      1, 0)
        sxw_d = lambda d: np.asarray(plan.sxw_s[d])
        syw_d = lambda d: np.asarray(plan.syw_s[d])
        lo = lambda sh: t - sh
        hi = lambda sh: sh - t
        e = selx(take(Wst, 0), hi(sxw_d(0)))
        w = selx(take(Est, 1), lo(sxw_d(1)))
        n = sely(take(Sst, 2), lo(syw_d(2)))
        s = sely(take(Nst, 3), hi(syw_d(3)))
        ne = selx(sely(take(Sst, 4)[:, :, :tm], lo(syw_d(4))), hi(sxw_d(4)))
        nw = selx(sely(take(Sst, 5)[:, :, Wm - tm:], lo(syw_d(5))),
                  lo(sxw_d(5)))
        se = selx(sely(take(Nst, 6)[:, :, :tm], hi(syw_d(6))), hi(sxw_d(6)))
        sw = selx(sely(take(Nst, 7)[:, :, Wm - tm:], hi(syw_d(7))),
                  lo(sxw_d(7)))
        return x4, e, w, n, s, ne, nw, se, sw

    def hybrid(v):
        S_loc, n_max, mu = v.shape
        Wm, tm = W * mu, t * mu
        x4, e, w, n, s, ne, nw, se, sw = _strips(v)
        # corners into the N/S full-width strips (thin)
        n = (n.at[:, :, Wm - tm:].add(ne + e[:, :t, :])
              .at[:, :, :tm].add(nw + w[:, :t, :]))
        s = (s.at[:, :, Wm - tm:].add(se + e[:, H - t:, :])
              .at[:, :, :tm].add(sw + w[:, H - t:, :]))
        em, wm = e[:, t:H - t, :], w[:, t:H - t, :]
        mid = (x4[:, t:H - t, :]
               + jnp.pad(em, [(0, 0), (0, 0), (Wm - tm, 0)])
               + jnp.pad(wm, [(0, 0), (0, 0), (0, Wm - tm)]))
        x4 = jnp.concatenate([x4[:, :t, :] + n, mid,
                              x4[:, H - t:, :] + s], axis=1)
        out = x4.reshape(S_loc, H * W, mu)
        if n_max > H * W:
            out = jnp.concatenate([out, v[:, H * W:, :]], axis=1)
        return out

    def allpad(v):
        S_loc, n_max, mu = v.shape
        Wm, tm = W * mu, t * mu
        x4, e, w, n, s, ne, nw, se, sw = _strips(v)
        e = e.at[:, :t, :].add(ne).at[:, H - t:, :].add(se)
        w = w.at[:, :t, :].add(nw).at[:, H - t:, :].add(sw)
        x4 = (x4
              + jnp.pad(e, [(0, 0), (0, 0), (Wm - tm, 0)])
              + jnp.pad(w, [(0, 0), (0, 0), (0, Wm - tm)])
              + jnp.pad(n, [(0, 0), (0, H - t), (0, 0)])
              + jnp.pad(s, [(0, 0), (H - t, 0), (0, 0)]))
        out = x4.reshape(S_loc, H * W, mu)
        if n_max > H * W:
            out = jnp.concatenate([out, v[:, H * W:, :]], axis=1)
        return out

    def dus(v):
        S_loc, n_max, mu = v.shape
        Wm, tm = W * mu, t * mu
        x4, e, w, n, s, ne, nw, se, sw = _strips(v)
        n = (n.at[:, :, Wm - tm:].add(ne + e[:, :t, :])
              .at[:, :, :tm].add(nw + w[:, :t, :]))
        s = (s.at[:, :, Wm - tm:].add(se + e[:, H - t:, :])
              .at[:, :, :tm].add(sw + w[:, H - t:, :]))
        em, wm = e[:, t:H - t, :], w[:, t:H - t, :]
        x4 = lax.dynamic_update_slice(
            x4, x4[:, :t, :] + n, (0, 0, 0))
        x4 = lax.dynamic_update_slice(
            x4, x4[:, H - t:, :] + s, (0, H - t, 0))
        x4 = lax.dynamic_update_slice(
            x4, x4[:, t:H - t, :tm] + wm, (0, t, 0))
        x4 = lax.dynamic_update_slice(
            x4, x4[:, t:H - t, Wm - tm:] + em, (0, t, Wm - tm))
        out = x4.reshape(S_loc, H * W, mu)
        if n_max > H * W:
            out = jnp.concatenate([out, v[:, H * W:, :]], axis=1)
        return out

    for name, fn in (
            ("floor", lambda v: v + 1.0),
            ("exchange", lambda v: scaled_exchange(dec, v)),
            ("strips_only", strips_only),
            ("copy_only", copy_only),
            ("hybrid", hybrid),
            ("allpad", allpad),
            ("dus", dus),
            ("gmv", lambda v: gmv(state, v))):
        print(f"{name:12s}: step {step_us(fn, x):8.1f} us", flush=True)


if __name__ == "__main__":
    main()
