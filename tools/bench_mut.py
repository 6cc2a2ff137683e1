#!/usr/bin/env python
"""Multi-RHS (muT, RHS-leading) GMV component benchmark.

At mu >= 3 the fused block GMV can spill its accumulator.  This tool
isolates, fetch-synced and length-differenced inside one process:

  * spmmT   : spmm_dia_canvas_muT on (S, mu, n)        [XLA canvas]
  * spmmS   : the same as a lax.scan over RHS pairs (mu > 2)
  * exchT   : d-scale + grid_exchange_muT
  * gmvT    : full muT GMV (spmm + scale + exchange), state as jit arg
  * gmvS    : the scanned GMV (mu > 2)

Usage: python tools/bench_mut.py [S Nx Ny] [--mu=1,2,4,8]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch  # noqa: E402


def scan_time_arg(fn, state, x, lengths=(6, 26), reps=3):
    """Length-differenced scan timing with the state as a jit argument."""
    import jax
    from jax import lax

    def chain(length):
        @jax.jit
        def run(st, v):
            out, _ = lax.scan(lambda c, _: (fn(st, c), None), v, None,
                              length=length)
            return out
        return run

    L1, L2 = lengths
    c1, c2 = chain(L1), chain(L2)
    y = c2(state, c1(state, x))
    fetch(y)
    w1 = w2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        y = c1(state, y)
        fetch(y)
        w1 = min(w1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        y = c2(state, y)
        fetch(y)
        w2 = min(w2, time.perf_counter() - t0)
    return max((w2 - w1) / (L2 - L1), 1e-9)


def main():
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.ops.spmv import spmm_dia_canvas_muT
    from hpddm_tpu.parallel.grid import grid_exchange_muT
    from hpddm_tpu.precond.schwarz import Schwarz

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dims = [int(a) for a in args[:3]] or [16, 2048, 2048]
    S, Nx, Ny = dims
    mus = [1, 2, 4, 8]
    for a in sys.argv[1:]:
        if a.startswith("--mu"):
            mus = [int(v) for v in a.split("=", 1)[1].split(",")]
    dtype = np.float32
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, dtype=dtype)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.operator_state()
    A = state.A
    nnz = sum(m.nnz for m in gen.mats)
    print(f"backend={jax.default_backend()} S={S} grid={Nx}x{Ny} "
          f"n_max={sch.n_max} nnz={nnz/1e6:.1f}M canvas={A.canvas_hw} "
          f"offsets={A.offsets}", flush=True)

    from hpddm_tpu.ops.spmv import spmm_dia_canvas_muT_scan
    from hpddm_tpu.parallel.grid import grid_exchange_muT_scan

    def gmvT(st, xT):
        dec = st.dec
        yT = spmm_dia_canvas_muT(st.A, xT) * dec.d[:, None, :]
        return grid_exchange_muT(dec.grid, yT, None)

    def gmvT_scan(st, xT):
        yT = spmm_dia_canvas_muT_scan(st.A, xT, pair=2,
                                      scale=st.dec.d)
        return grid_exchange_muT_scan(st.dec.grid, yT, None)

    rng = np.random.default_rng(0)
    for mu in mus:
        xT = jnp.asarray(rng.normal(size=(S, mu, sch.n_max)).astype(dtype))
        rows = {}
        rows["spmmT"] = scan_time_arg(
            lambda st, v: spmm_dia_canvas_muT(st.A, v), state, xT)
        if mu > 2:
            rows["spmmS"] = scan_time_arg(
                lambda st, v: spmm_dia_canvas_muT_scan(st.A, v, pair=2),
                state, xT)
        rows["exchT"] = scan_time_arg(
            lambda st, v: grid_exchange_muT(
                st.dec.grid, v * st.dec.d[:, None, :], None), state, xT)
        if mu > 1:
            rows["exchS"] = scan_time_arg(
                lambda st, v: grid_exchange_muT_scan(
                    st.dec.grid, v * st.dec.d[:, None, :], None), state, xT)
        rows["gmvT"] = scan_time_arg(gmvT, state, xT)
        if mu > 2:
            rows["gmvS"] = scan_time_arg(gmvT_scan, state, xT)
        msg = f"mu={mu}:"
        for k, v in rows.items():
            msg += f"  {k}={v*1e6:8.1f}us({v*1e6/mu:7.1f}/rhs)"
        print(msg, flush=True)


if __name__ == "__main__":
    main()
