#!/usr/bin/env python
"""Batched subdomain-count ladder on one chip.

The reference's identity is thousands of subdomains across MPI ranks
(HPDDM_coarse_operator_impl.hpp:282-1248); here the same decomposition
runs *batched* on one chip: S in {16, 64, 256} at a fixed global grid, so
the per-subdomain size shrinks while the two-level machinery (GenEO via
matrix-free Lanczos, block-sparse coarse with nested level-2 solves)
carries the growing coarse problem. dst_cheby local solves keep factor
memory at zero, so the ladder is not bound by host-to-device transfers.

Usage: python tools/bench_sladder.py [Nx [S ...]]   (default 2048, 16 64 256)
Iteration-count parity vs the CPU f64 oracle: run the same command with
JAX_PLATFORMS=cpu-forced interpreters (tests/conftest.py style) — the
script prints the same table either way.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def run_point(S, Nx, Ny, nu, steps, tol=None):
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.core.scaling import jacobi_scale
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import solve

    from hpddm_tpu.device import working_dtype
    dtype = working_dtype()
    if tol is None:
        # the f32 true-residual floor grows with global size (~3e-3 at
        # 1024^2, ~1.2e-2 at 2048^2 — PERF.md): solve to just above it and
        # leave tighter accuracy to host-f64 iterative refinement
        # (solvers/refine.py), the flagship protocol
        tol = (2e-3 if Nx >= 2048 else 1e-6) if dtype == np.float32 \
            else 1e-8

    def kappa(xx, yy):
        return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
                * np.where(xx > 5.0, 10.0, 1.0))

    t0 = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, kappa=kappa,
                                       with_neumann=True, dtype=dtype)
    mats, f_list, neumann, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    t_gen = time.perf_counter() - t0
    # bsr ASSEMBLY (O(S*neighbors), no global-column tensor) + replicated
    # dense direct coarse solve: at nc = S*nu <= ~20k the direct solve is
    # the right design (the reference's main-process direct factorization
    # of the assembled sparse E, host-f64-then-rounded). The nested
    # iterative level-2 modes exist for larger nc; on the f32 chip their
    # achievable inner residual floors near 1e-5 and the first ladder
    # attempts stalled (inner 1e-2 -> outer plateau 1e-2) or diverged
    # (tight inner tols in f32) — see PERF.md round 3.
    opt = Options(tol=tol, local_solver="dst_cheby",
                  local_cheby_steps=steps,
                  schwarz_coarse_correction="deflated", geneo_nu=nu,
                  coarse_assembly="bsr")
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.set_grid_geometry(gen.boxes, Nx, Ny)

    t0 = time.perf_counter()
    sch.solve_gevp(neumann, method="lanczos")
    t_gevp = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sch.build()
    _fetch_sync(state.dec.d)
    t_build = time.perf_counter() - t0

    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = f_list[s]
    f = jnp.asarray(f)
    solve_jit = jax.jit(lambda st, b: solve(st, b, opt=opt))
    res = solve_jit(state, f)
    _fetch_sync(res.x)                   # compile + first run
    t0 = time.perf_counter()
    res = solve_jit(state, f)
    _fetch_sync(res.x)
    t_solve = time.perf_counter() - t0
    rr = np.array(compute_residual(state, res.x, f)).ravel()
    its = int(res.iterations)
    nc = int(np.asarray(state.coarse.nu_loc).sum()) if state.coarse else 0
    print(f"S={S:4d} n_loc~{gen.n_loc[0]:7d} nc={nc:5d} "
          f"gen={t_gen:5.1f}s gevp={t_gevp:6.1f}s build={t_build:5.1f}s  "
          f"solve: {its:3d} its {t_solve:7.3f}s "
          f"({t_solve/max(its,1)*1e3:6.1f} ms/it) relres {rr[-1]:.2e}",
          flush=True)
    return its, t_solve


def main():
    tol = None
    args = []
    for a in sys.argv[1:]:
        if a.startswith("tol="):
            tol = float(a[4:])
        else:
            args.append(int(a))
    Nx = args[0] if args else 2048
    Ss = args[1:] or [16, 64, 256]
    import jax
    print(f"backend={jax.default_backend()} grid={Nx}x{Nx}", flush=True)
    for S in Ss:
        # nu sized to the local space: 16 GenEO modes need >=50k-dof
        # subdomains in f32 (at 16.9k locals nu=16 under-deflates after
        # rank truncation — 100-it stall vs 78 its at nu=8; at 4.4k it
        # used to diverge outright; PERF.md round 3)
        nu = 16 if (Nx * Nx) // S >= 50000 else 8
        run_point(S, Nx, Nx, nu=nu, steps=32, tol=tol)


if __name__ == "__main__":
    main()
