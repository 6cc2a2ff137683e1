#!/usr/bin/env python
"""Large-scale heterogeneous ELASTICITY flagship on the current backend.

512x512 nodes (0.52M dofs, or argv override), 8 x-slab subdomains of
~66k dofs, checkerboard Young's modulus, -hpddm_local_solver banded with
dense (node-block) coupling — the exact-local-solve path that no dense
factorization (66k^2 floats per subdomain) or DST solver (non-separable
operator) covers. Two-level GenEO from the matrix-free Lanczos GEVP on
the unassembled element-sum Neumann matrices.

Usage: python tools/bench_elasticity.py [S Nnodes nu contrast]
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
    from hpddm_tpu.models import elasticity2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import solve
    from hpddm_tpu.core.scaling import jacobi_scale

    argv = [a for a in sys.argv[1:]]
    vals = [int(float(a)) for a in argv[:3]]
    S, Nn, nu = (vals + [8, 512, 16][len(vals):])
    contrast = float(argv[3]) if len(argv) > 3 else 1e3
    from hpddm_tpu.device import working_dtype
    dtype = working_dtype()
    # f32 elasticity: the preconditioned-residual floor sits near 1e-4
    # (PERF.md) — converge the f32 inner solve to 1e-3 and reach f64-grade
    # accuracy through the refinement passes below
    tol = 1e-2 if dtype == np.float32 else 1e-8

    t0 = time.perf_counter()
    # 2D box partition (aspect-ratio-friendly; boxes stay rectangles)
    gx = int(np.sqrt(S))
    while S % gx:
        gx -= 1
    gy = S // gx
    gen, neumann, rbm = elasticity2d.generate(
        S, Nx=Nn, Ny=Nn, contrast=contrast, overlap=2,
        owner_fn=lambda ix, iy: (min(iy * gy // Nn, gy - 1) * gx
                                 + min(ix * gx // Nn, gx - 1)))
    # x-slab node rectangles -> banded shapes (rows=node rows, 2 dofs/node)
    shapes = []
    for s in range(S):
        nodes = np.unique(gen.gids[s] // 2)
        ix, iy = nodes % Nn, nodes // Nn
        wx = int(ix.max() - ix.min() + 1)
        wy = int(iy.max() - iy.min() + 1)
        assert gen.n_loc[s] == 2 * wx * wy
        shapes.append((wy, 2 * wx))
    mats = [m.astype(dtype) if hasattr(m, "astype") else m
            for m in gen.mats]
    mats, f_list, neumann, _ = jacobi_scale(gen.mats, gen.f, neumann)
    t_gen = time.perf_counter() - t0

    opt = Options(tol=tol, max_it=300, gmres_restart=60,
                  orthogonalization="mgs" if dtype == np.float32 else "cgs",
                  local_solver="banded",
                  schwarz_coarse_correction="deflated", geneo_nu=nu)
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.set_banded_shapes(shapes)
    print(f"backend={jax.default_backend()} S={S} nodes={Nn}x{Nn} "
          f"ndof={gen.A_global.shape[0]} n_loc~{gen.n_loc[0]} nu={nu} "
          f"contrast={contrast:g} gen={t_gen:.1f}s", flush=True)

    t0 = time.perf_counter()
    sch.solve_gevp(neumann, method="lanczos")
    t_gevp = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sch.build()
    _fetch_sync(state.dec.d)
    t_build = time.perf_counter() - t0
    print(f"setup: gevp={t_gevp:.1f}s build={t_build:.1f}s", flush=True)

    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s], 0] = f_list[s][:, 0]
    f = sch.exchange_rhs(jnp.asarray(f))
    solve_jit = jax.jit(lambda st, b: solve(st, b, opt=opt))
    res = solve_jit(state, f)
    _fetch_sync(res.x)
    t0 = time.perf_counter()
    res = solve_jit(state, f)
    _fetch_sync(res.x)
    t_solve = time.perf_counter() - t0
    nb, nr = compute_residual(state, res.x, f)
    its = int(res.iterations)
    print(f"solve: {its} its, {t_solve:.3f}s "
          f"({t_solve/max(its,1)*1e3:.1f} ms/it), true relres "
          f"{float(nr[0]/nb[0]):.3e}", flush=True)

    if dtype == np.float32:
        # mixed-precision refinement: host-f64 residuals around the f32
        # device solve (solvers/refine.py) -> f64-grade accuracy
        from hpddm_tpu.solvers.refine import solve_refined
        t0 = time.perf_counter()
        x, info = solve_refined(lambda b: solve_jit(state, jnp.asarray(b)),
                                mats, np.asarray(f), state.dec,
                                tol=1e-8, max_refine=12)
        t_ir = time.perf_counter() - t0
        print(f"refined: {len(info['inner_iterations'])} passes x "
              f"{info['inner_iterations']} its, {t_ir:.2f}s, "
              f"true f64 relres {info['history'][-1]:.3e}", flush=True)


if __name__ == "__main__":
    main()
