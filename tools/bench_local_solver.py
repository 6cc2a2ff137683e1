#!/usr/bin/env python
"""Local-solver benchmark: the reference's benchmark/local_solver.cpp
protocol (warm_up=1, trials=3, RHS sweep mu..1, numfact and solve timed
separately — local_solver.cpp:89-133) over the batched local-solver
family (-hpddm_local_solver inv/lu/chol/qr/fft/dst_cheby/banded).

One "local solve" here is the *batched* application over all S subdomains
at once — the unit the Schwarz smoother actually executes — so the solve
column is directly the smoother cost per preconditioner apply. Device
timing is length-differenced through a lax.scan chain (the fixed
per-call overhead cancels).

Usage: python tools/bench_local_solver.py [S Nx Ny] [mu_max] [solver ...]
       (defaults: 16 512 512, mu_max 4, all applicable solvers)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402

WARM_UP = 1
TRIALS = 3


def bench_solver(name, gen, S, Nx, Ny, mu_max, dtype):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz

    opt = Options(local_solver=name)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    if name in ("fft", "dst_cheby", "banded"):
        sch.set_grid_geometry(gen.boxes, Nx, Ny)
    t0 = time.perf_counter()
    try:
        state = sch.build()
    except Exception as e:                                # noqa: BLE001
        print(f"{name:>9s}  n/a ({type(e).__name__}: {e})", flush=True)
        return
    _fetch_sync(state.dec.d)
    t_numfact = time.perf_counter() - t0

    mus, mu = [], mu_max
    while mu >= 1:
        mus.append(mu)
        mu //= 2
    cols = []
    for mu in mus:
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(S, sch.n_max, mu)).astype(dtype))

        def chain(length):
            @jax.jit
            def run(v):
                out, _ = lax.scan(
                    lambda c, _: (state.solver.solve(c), None), v, None,
                    length=length)
                return out
            return run

        L1, L2 = 4, 20
        c1, c2 = chain(L1), chain(L2)
        y = x
        for _ in range(max(WARM_UP, 1)):               # compile + warm-up
            y = c2(c1(y))
        _fetch_sync(y)
        w1 = w2 = float("inf")
        for _ in range(TRIALS):
            t0 = time.perf_counter()
            y = c1(y)
            _fetch_sync(y)
            w1 = min(w1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            y = c2(y)
            _fetch_sync(y)
            w2 = min(w2, time.perf_counter() - t0)
        cols.append((mu, max((w2 - w1) / (L2 - L1), 0.0)))
    solve_str = "  ".join(f"mu={m}: {t*1e3:8.3f} ms" for m, t in cols)
    print(f"{name:>9s}  numfact {t_numfact:7.2f} s   solve {solve_str}",
          flush=True)


def main():
    args = [a for a in sys.argv[1:]]
    nums = [int(a) for a in args if a.isdigit()]
    solvers = [a for a in args if not a.isdigit()]
    # positional numeric args override the defaults prefix-wise:
    # [S [Nx [Ny [mu_max]]]]
    defaults = [16, 512, 512, 4]
    if len(nums) > len(defaults):
        sys.exit(f"usage: {sys.argv[0]} [S [Nx [Ny [mu_max]]]] [solvers...]")
    S, Nx, Ny, mu_max = nums + defaults[len(nums):]
    import jax
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.device import working_dtype
    dtype = working_dtype()
    if not solvers:
        solvers = ["inv", "lu", "chol", "fft", "dst_cheby", "banded"]
    print(f"backend={jax.default_backend()} S={S} grid={Nx}x{Ny} "
          f"(n_loc ~ {(Nx // int(np.sqrt(S))) * (Ny // int(np.sqrt(S)))}) "
          f"warm_up={WARM_UP} trials={TRIALS}", flush=True)
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, dtype=dtype)
    for name in solvers:
        bench_solver(name, gen, S, Nx, Ny, mu_max, dtype)


if __name__ == "__main__":
    main()
