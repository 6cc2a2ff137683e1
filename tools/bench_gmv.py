#!/usr/bin/env python
"""In-scan microbenchmark of the GMV components on the current backend.

Measures (inside a lax.scan chain, so per-call dispatch cancels out):
  * floor: trivial elementwise op (scan overhead)
  * spmm (XLA DIA), single and multi-RHS
  * exchange (grid fast path or general), gmv total

Usage: python tools/bench_gmv.py [S Nx Ny]   (default 16 2048 2048)
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
    from hpddm_tpu.ops.spmv import spmm
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
    A = state.A
    nnz = sum(m.nnz for m in gen.mats)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)).astype(dtype))

    print(f"backend={jax.default_backend()} S={S} grid={Nx}x{Ny} "
          f"n_max={sch.n_max} nnz={nnz/1e6:.1f}M fmt={type(A).__name__} "
          f"ndiag={A.values.shape[1] if hasattr(A, 'offsets') else '-'}")

    floor = scan_time(lambda v: v + 1.0, x)
    print(f"scan floor     : {floor*1e6:9.1f} us")

    t_x = scan_time(lambda v: spmm(A, v), x)
    print(f"spmm XLA       : {t_x*1e6:9.1f} us  ({nnz/t_x/1e9:.1f} GNnz/s)")

    # multi-RHS
    for mu in (2, 4):
        xm = jnp.asarray(np.random.default_rng(1).normal(
            size=(S, sch.n_max, mu)).astype(dtype))
        from hpddm_tpu.ops.spmv import spmm_dia
        t_xm = scan_time(lambda v: spmm_dia(A, v), xm)
        print(f"spmm XLA  mu={mu} : {t_xm*1e6:9.1f} us  "
              f"({mu*nnz/t_xm/1e9:.1f} GNnz/s eff)")

    t_e = scan_time(lambda v: scaled_exchange(state.dec, v), x)
    print(f"exchange       : {t_e*1e6:9.1f} us")

    t_g = scan_time(lambda v: gmv(state, v), x)
    print(f"gmv total      : {t_g*1e6:9.1f} us  ({nnz/t_g/1e9:.1f} GNnz/s)")

    # general (non-grid) path: row-plan vs legacy element scatter
    import dataclasses
    dec_gen = dataclasses.replace(state.dec, grid=None)
    t_rp = scan_time(lambda v: scaled_exchange(dec_gen, v), x)
    print(f"exch rowplan   : {t_rp*1e6:9.1f} us")
    dec_leg = dataclasses.replace(dec_gen, rowplan=None)
    t_lg = scan_time(lambda v: scaled_exchange(dec_leg, v), x)
    print(f"exch legacy    : {t_lg*1e6:9.1f} us")


if __name__ == "__main__":
    main()
