#!/usr/bin/env python
"""Unstructured P1 FEM Schwarz driver (round 5).

The in-tree genuinely-unstructured workload: a jittered Delaunay FEM
Laplacian (optionally graded / heterogeneous), partitioned algebraically
and solved with two-level GenEO-RAS on FEM Neumann matrices:

    python examples/unstructured.py -N 8 -Nx 60 [-grading 0.5]
        [-contrast 1e4] [-hpddm_schwarz_coarse_correction deflated]
        [-hpddm_geneo_nu 8] [-hpddm_* ...]

The pipeline runs the ELL SpMV with the general exchange (band-ordered
local numbering) and RCM banded exact local solves.
Exit 0 on convergence with a true global residual check."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import jax.numpy as jnp
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import unstructured
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz
    from hpddm_tpu.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<8>", "Number of subdomains."),
           ("Nx=<60>", "Mesh points per side."),
           ("overlap=<2>", "Overlap growth rounds."),
           ("Nz=<0>", "3-D: mesh points along z (0 = 2-D triangles)."),
           ("grading=<0.0>", "Mesh grading toward the origin."),
           ("contrast=<1.0>", "Coefficient contrast of the channel.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    nx = int(opt.app()["Nx"])
    contrast = float(opt.app()["contrast"])
    kap = None
    if contrast != 1.0:
        kap = (lambda x, y: np.where((y > 0.33) & (y < 0.66),
                                     contrast, 1.0))
    two_level = opt.val("schwarz_coarse_correction") is not None
    nz = int(opt.app()["Nz"])
    if kap is not None and nz:
        kap2d = kap
        kap = (lambda x, y, z: kap2d(x, y))
    gen = unstructured.generate(
        S, nx, nx, nz=nz, overlap=int(opt.app()["overlap"]), kappa=kap,
        grading=float(opt.app()["grading"]), with_neumann=two_level,
        partition="geometric" if nx * nx * max(nz, 1) > 200000
        else "kway")

    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    if two_level:
        sch.solve_gevp(gen.neumann)
    state = sch.build()
    dtype = working_dtype()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    res = solve(state, jnp.asarray(f), opt=opt)

    # true residual on the assembled global system
    xs = np.asarray(res.x, dtype=np.float64)
    N = gen.A_global.shape[0]
    xg = np.zeros(N)
    for s in range(S):
        xg[gen.gids[s]] = xs[s, : gen.n_loc[s], 0]
    fg = np.where(gen.boundary, 0.0, 1.0)
    rel = np.linalg.norm(gen.A_global @ xg - fg) / np.linalg.norm(fg)
    print(f" --- true residual = {rel:.6e}")
    print(f"iterations: {int(res.iterations)}")
    tol_gate = 1e-4 if dtype == np.float32 else 1e-6
    return 0 if (int(res.iterations) <= 60 and rel <= tol_gate) else 1


if __name__ == "__main__":
    sys.exit(main())
