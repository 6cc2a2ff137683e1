#!/usr/bin/env python
"""Large-scale heterogeneous flagship run on the current backend.

1024x1024 grid (or argv override), 16 uniform subdomains of ~66k dofs,
diffusion coefficient with a contrast-1e4 channel + quadrant jump,
-hpddm_local_solver dst_cheby (no factorization memory anywhere) with a
GenEO coarse space from the matrix-free Lanczos GEVP. No batched dense
factor fits these subdomains (66k^2 floats each); this is the config the
DST+Chebyshev+Lanczos path exists for.

Usage: python tools/bench_hetero.py [S Nx Ny nu steps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import solve

    args = sys.argv[1:]
    local = "dst_cheby"
    block_rows = 1
    while args and not args[-1].isdigit():
        tok = args.pop()
        if tok.startswith("r") and tok[1:].isdigit():
            block_rows = int(tok[1:])
        else:
            local = tok
    argv = [int(a) for a in args[:5]]
    S, Nx, Ny, nu, steps = (argv + [16, 1024, 1024, 16, 32][len(argv):])
    from hpddm_tpu.device import working_dtype
    dtype = working_dtype()
    tol = 1e-6 if dtype == np.float32 else 1e-8

    def kappa(xx, yy):
        return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
                * np.where(xx > 5.0, 10.0, 1.0))

    t0 = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, kappa=kappa,
                                       with_neumann=True, dtype=dtype)
    # symmetric Jacobi scaling: mandatory for f32 at this contrast
    # (cond(A_loc) ~ contrast x grid-cond makes any f32 local solve
    # meaningless otherwise; core/scaling.py)
    from hpddm_tpu.core.scaling import jacobi_scale
    mats, f_list, neumann, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    t_gen = time.perf_counter() - t0
    # bsr assembly + replicated direct coarse: same 23 its as the dense
    # assembly at this config, 37 s vs 54 s coarse build (round 3)
    opt = Options(tol=tol, local_solver=local,
                  local_cheby_steps=steps, banded_block_rows=block_rows,
                  schwarz_coarse_correction="deflated", geneo_nu=nu,
                  coarse_assembly="bsr")
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    print(f"backend={jax.default_backend()} S={S} grid={Nx}x{Ny} "
          f"n_loc~{gen.n_loc[0]} nu={nu} local={local}(r={block_rows}) "
          f"cheby_steps={steps} "
          f"gen={t_gen:.1f}s", flush=True)

    t0 = time.perf_counter()
    sch.solve_gevp(neumann, method="lanczos")
    t_gevp = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sch.build()
    _fetch_sync(state.coarse.EinvZ
                          if hasattr(state.coarse, "EinvZ") else state.dec.d)
    t_build = time.perf_counter() - t0
    print(f"setup: gevp={t_gevp:.1f}s build={t_build:.1f}s", flush=True)

    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = f_list[s]
    f = jnp.asarray(f)
    # state as a jit ARGUMENT, not a closure: closure-captured states are
    # embedded into the HLO as literals (banded factors ~1 GB here)
    solve_jit = jax.jit(lambda st, b: solve(st, b, opt=opt))
    res = solve_jit(state, f)
    _fetch_sync(res.x)
    t0 = time.perf_counter()
    res = solve_jit(state, f)
    _fetch_sync(res.x)
    t_solve = time.perf_counter() - t0
    rr = np.array(compute_residual(state, res.x, f)).ravel()
    its = int(res.iterations)
    ndof = Nx * Ny
    print(f"solve: {its} its, {t_solve:.3f}s "
          f"({t_solve/max(its,1)*1e3:.1f} ms/it), true relres {rr[-1]:.3e}, "
          f"{ndof/1e6:.1f}M dofs", flush=True)

    # mixed-precision iterative refinement: host-f64 residuals around the
    # f32 device solve
    from hpddm_tpu.solvers.refine import solve_refined
    opt_ir = Options(tol=1e-3, local_solver=local,
                     local_cheby_steps=steps,
                     schwarz_coarse_correction="deflated", geneo_nu=nu)
    ir_jit = jax.jit(lambda b: solve(state, jnp.asarray(b), opt=opt_ir)) \
        if local != "banded" else \
        (lambda b: solve_ir_jit(state, jnp.asarray(b)))
    solve_ir_jit = jax.jit(lambda st, b: solve(st, b, opt=opt_ir))
    t0 = time.perf_counter()
    x, info = solve_refined(ir_jit, mats, np.asarray(f), state.dec,
                            tol=1e-10, max_refine=6)
    t_ir = time.perf_counter() - t0
    print(f"refined: {len(info['inner_iterations'])} passes x "
          f"{info['inner_iterations']} its, {t_ir:.2f}s (incl. compile), "
          f"true f64 relres {info['history'][-1]:.3e}", flush=True)

    # all-on-device variant: double-word f32 residuals (no host SpMV)
    from hpddm_tpu.solvers.refine import solve_refined_device
    t0 = time.perf_counter()
    x2, info2 = solve_refined_device(state, f, opt=opt_ir, tol=1e-10,
                                     max_refine=6)
    t_ir2 = time.perf_counter() - t0
    print(f"refined-dw: {len(info2['inner_iterations'])} passes x "
          f"{info2['inner_iterations']} its, {t_ir2:.2f}s (incl. compile), "
          f"dw relres {info2['history'][-1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
