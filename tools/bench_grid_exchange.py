#!/usr/bin/env python
"""In-scan cost breakdown of the structured-grid halo exchange.

Locates the cost center of parallel/grid.py::grid_exchange on the current
backend: the flat<->canvas relayout, the strip extraction, the neighbor
gather+realign, and the two final compositions (row-band concat vs
zero-padded adds) measured in the same process, so run-to-run noise
cancels.
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
    from hpddm_tpu.parallel import grid as gridmod
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
    print(f"backend={jax.default_backend()} S={S} H={H} W={W} t={t}")

    floor = scan_time(lambda v: v + 1.0, x)
    print(f"floor          : {floor*1e6:9.1f} us")

    n_max = x.shape[1]

    def roundtrip(v):
        c = v[:, : H * W, :].reshape(S, H, W, 1) + 1.0
        out = c.reshape(S, H * W, 1)
        return jnp.concatenate([out, v[:, H * W:, :]], axis=1) \
            if n_max > H * W else out
    print(f"canvas roundtr : {scan_time(roundtrip, x)*1e6:9.1f} us")

    def strips(v):
        c = v[:, : H * W, :].reshape(S, H, W, 1)
        Est = c[:, :, W - t:, :]
        Wst = c[:, :, :t, :]
        Nst = c[:, :t, :, :]
        Sst = c[:, H - t:, :, :]
        s = Est.sum() + Wst.sum() + Nst.sum() + Sst.sum()
        return v + s * 1e-30
    print(f"strip extract  : {scan_time(strips, x)*1e6:9.1f} us")

    # cumulative stages of the exchange internals
    plan_oh = plan.onehot.astype(x.dtype)

    def stage(v, upto):
        c = v[:, : H * W, :].reshape(S, H, W, 1)
        Est, Wst = c[:, :, W - t:, :], c[:, :, :t, :]
        Nst, Sst = c[:, :t, :, :], c[:, H - t:, :, :]
        z = lambda s_: jnp.concatenate(
            [s_, jnp.zeros((1,) + s_.shape[1:], s_.dtype)], axis=0)
        Ep, Wp, Np, Sp = z(Est), z(Wst), z(Nst), z(Sst)
        take = lambda sp, d: jnp.einsum("sq,qabm->sabm", plan_oh[:, d, :], sp)
        acc = 0.0
        if upto >= 1:
            for d, sp in ((0, Wp), (1, Ep), (2, Sp), (3, Np)):
                acc = acc + take(sp, d).sum()
        if upto >= 2:
            sh = gridmod._shift_select
            e = sh(take(Wp, 0), plan.sxw[:, 0] - t, 2, t)
            w = sh(take(Ep, 1), t - plan.sxw[:, 1], 2, t)
            n = sh(take(Sp, 2), t - plan.syw[:, 2], 1, t)
            s_ = sh(take(Np, 3), plan.syw[:, 3] - t, 1, t)
            acc = acc + e.sum() + w.sum() + n.sum() + s_.sum()
        return v + acc * 1e-30

    print(f"stage onehot   : {scan_time(lambda v: stage(v, 1), x)*1e6:9.1f} us")
    print(f"stage +shift   : {scan_time(lambda v: stage(v, 2), x)*1e6:9.1f} us")

    for mode in ("band", "pad"):
        gridmod._COMPOSE = mode
        tt = scan_time(lambda v: scaled_exchange(dec, v), x)
        print(f"exchange {mode:4s}  : {tt*1e6:9.1f} us")


if __name__ == "__main__":
    main()
