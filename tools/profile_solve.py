#!/usr/bin/env python
"""Micro-profile of the solve hot loop on the current backend: times GMV,
one-level apply, two-level apply, the CGS Gram step, and a full GMRES
solve, to locate the cost center before kernel-level optimization."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def timeit(fn, *args, reps=20):
    import jax
    out = fn(*args)
    _fetch_sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _fetch_sync(out)
    return (time.perf_counter() - t0) / reps


def main():
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond import schwarz as sz
    from hpddm_tpu.solvers.krylov import make_operator, solve

    from hpddm_tpu.device import working_dtype
    dtype = working_dtype()
    S, Nx, Ny = 4, 100, 100
    gen = diffusion2d.generate(S, Nx, Ny, overlap=1, with_neumann=True,
                               dtype=dtype)
    opt = Options(tol=1e-6, schwarz_coarse_correction="deflated",
                  geneo_nu=10)
    sch = sz.Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                     options=opt)
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = jnp.asarray(f)

    gmv_j = jax.jit(lambda x: sz.gmv(state, x))
    apply1_j = jax.jit(lambda x: sz.one_level_apply(state, x))
    apply2_j = jax.jit(lambda x: sz.apply(state, x))
    solve_j = jax.jit(lambda b: solve(state, b, opt=opt))

    op = make_operator(state)
    m = 41
    V = jnp.asarray(np.random.default_rng(0).normal(
        size=(m, S, sch.n_max, 1)).astype(dtype))
    gram_j = jax.jit(lambda VV, y: op.gram(VV, y))

    # local solver alone
    from hpddm_tpu.parallel.ops import scaled_exchange
    ls_j = jax.jit(lambda x: state.solver.solve(x))
    exch_j = jax.jit(lambda x: scaled_exchange(state.dec, x))

    print(f"backend={jax.default_backend()} dtype={dtype.__name__} "
          f"S={S} n_max={sch.n_max}")
    print(f"gmv            : {timeit(gmv_j, f) * 1e6:9.1f} us")
    print(f"local solve    : {timeit(ls_j, f) * 1e6:9.1f} us")
    print(f"exchange       : {timeit(exch_j, f) * 1e6:9.1f} us")
    print(f"apply 1-level  : {timeit(apply1_j, f) * 1e6:9.1f} us")
    print(f"apply 2-level  : {timeit(apply2_j, f) * 1e6:9.1f} us")
    print(f"gram (41 vecs) : {timeit(gram_j, V, f) * 1e6:9.1f} us")
    res = solve_j(f)
    _fetch_sync(res.x)
    t = timeit(solve_j, f, reps=3)
    print(f"full solve     : {t * 1e3:9.2f} ms  "
          f"({int(res.iterations)} its, {t / max(int(res.iterations), 1) * 1e6:.0f} us/it)")


if __name__ == "__main__":
    main()
