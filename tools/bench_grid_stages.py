#!/usr/bin/env python
"""Regular-path stage breakdown of grid_exchange (PERF.md floor hunt).

Stages: strip extract -> neighbor takes (static grid shifts) -> realign
selects -> band composition. Each stage timed in-scan in one process.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def scan_time(fn, x, length=20, reps=3):
    import jax
    from jax import lax

    @jax.jit
    def chain(v):
        out, _ = lax.scan(lambda c, _: (fn(c), None), v, None, length=length)
        return out

    y = chain(x)
    _fetch_sync(y)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = chain(y)
    _fetch_sync(y)
    return (time.perf_counter() - t0) / (reps * length)


def main():
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.parallel import grid as G
    from hpddm_tpu.parallel.ops import scaled_exchange
    from hpddm_tpu.precond.schwarz import Schwarz

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
    H, W, t = plan.H, plan.W, plan.t
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)).astype(dtype))
    print(f"backend={jax.default_backend()} S={S} H={H} W={W} t={t} "
          f"regular={plan.regular}")

    def reduce_mix(v, *parts):
        acc = 0.0
        for p in parts:
            acc = acc + p.sum()
        return v + acc * 1e-30

    def takes(v, upto):
        x4 = v[:, : H * W, :].reshape(S, H, W, 1)
        Est = x4[:, :, W - t:, :]
        Wst = x4[:, :, :t, :]
        Nst = x4[:, :t, :, :]
        Sst = x4[:, H - t:, :, :]

        def take(strips, dir_):
            dy, dx = G._DIRS[dir_]
            g = strips.reshape((plan.gy, plan.gx) + strips.shape[1:])
            g = G._static_shift(G._static_shift(g, dy, 0), dx, 1)
            return g.reshape(strips.shape)

        parts = [take(Wst, 0), take(Est, 1), take(Sst, 2), take(Nst, 3),
                 take(Sst, 4), take(Sst, 5), take(Nst, 6), take(Nst, 7)]
        if upto == 1:
            return reduce_mix(v, *parts)
        sxw_d = lambda d: np.asarray(plan.sxw_s[d])
        syw_d = lambda d: np.asarray(plan.syw_s[d])
        sel = lambda vals, k, axis: G._shift_select_static(vals, k, axis, 0)
        Wp, Ep, Sp, Np = parts[0], parts[1], parts[2], parts[3]
        e = sel(Wp, sxw_d(0) - t, 2)
        w = sel(Ep, t - sxw_d(1), 2)
        n = sel(Sp, t - syw_d(2), 1)
        s_ = sel(Np, syw_d(3) - t, 1)
        ne = sel(sel(parts[4][:, :, :t, :], t - syw_d(4), 1), sxw_d(4) - t, 2)
        nw = sel(sel(parts[5][:, :, W - t:, :], t - syw_d(5), 1),
                 t - sxw_d(5), 2)
        se = sel(sel(parts[6][:, :, :t, :], syw_d(6) - t, 1), sxw_d(6) - t, 2)
        sw = sel(sel(parts[7][:, :, W - t:, :], syw_d(7) - t, 1),
                 t - sxw_d(7), 2)
        return reduce_mix(v, e, w, n, s_, ne, nw, se, sw)

    floor = scan_time(lambda v: v + 1.0, x)
    print(f"floor          : {floor*1e6:9.1f} us")

    def forced_canvas(v):
        """flat->canvas->flat with the canvas *materialized* (concat makes
        the 2D layout real; the naive roundtrip fuses to elementwise)."""
        c = v[:, : H * W, :].reshape(S, H, W)
        c = jnp.concatenate([c[:, :t, :] + 1.0, c[:, t:, :]], axis=1)
        return c.reshape(S, H * W, 1)
    print(f"forced canvas  : {scan_time(forced_canvas, x)*1e6:9.1f} us")

    def forced_canvas_ew(v):
        c = v[:, : H * W, :].reshape(S, H, W)
        c = jnp.concatenate([c[:, :, :t] + 1.0, c[:, :, t:]], axis=2)
        return c.reshape(S, H * W, 1)
    print(f"forced canv EW : {scan_time(forced_canvas_ew, x)*1e6:9.1f} us")
    print(f"takes (8)      : {scan_time(lambda v: takes(v, 1), x)*1e6:9.1f} us")
    print(f"takes+selects  : {scan_time(lambda v: takes(v, 2), x)*1e6:9.1f} us")
    tt = scan_time(lambda v: scaled_exchange(dec, v), x)
    print(f"full exchange  : {tt*1e6:9.1f} us")


if __name__ == "__main__":
    main()
