#!/usr/bin/env python
"""Algebraic Schwarz driver for assembled matrices — the analogue of
examples/schwarzFromFile.cpp + generateFromFile.cpp:

    python examples/schwarz_from_file.py -matrix_filename mini.mtx \
        -N 4 -overlap 3 [-rhs_filename ones.txt] [-hpddm_* ...]

Partitions the matrix algebraically (RCM blocks instead of METIS), grows
overlap by powers of |A|, and solves with the configured Schwarz/Krylov
method. Exit 0 on convergence."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import jax.numpy as jnp
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.core.csr import MatrixCSR
    from hpddm_tpu.models import fromfile
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("overlap=<1>", "Overlap growth rounds."),
           ("matrix_filename=<input_file>", "Matrix file (mtx or HPDDM dump)."),
           ("rhs_filename=<input_file>", "RHS file (one value per line).")]
    opt = Options.parse(argv, display=True, app_options=app)
    path = opt.app().get("matrix_filename")
    if not path or not isinstance(path, str):
        print("missing -matrix_filename", file=sys.stderr)
        return 2
    dtype = working_dtype()
    A = MatrixCSR.from_file(path, dtype=dtype)
    rhs_path = opt.app().get("rhs_filename")
    f_global = None
    if isinstance(rhs_path, str) and rhs_path:
        f_global = np.loadtxt(rhs_path).astype(dtype)

    S = int(opt.app()["N"])
    gen = fromfile.decompose(A, S, overlap=int(opt.app()["overlap"]),
                             f_global=f_global)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    if opt.val("schwarz_coarse_correction") is not None:
        # fully-algebraic GenEO (round 5): SPSD splitting of the assembled
        # matrix stands in for user auxiliary Neumann matrices (the
        # PCHPDDM + aldaas2021robust front-end)
        sch.solve_gevp(fromfile.spsd_neumann(gen))
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = jnp.asarray(f)

    state = sch.build()
    res = solve(state, f, opt=opt)
    nb, nr = compute_residual(state, res.x, f)
    rel = float(np.asarray(nr)[0] / np.asarray(nb)[0])
    print(f" --- residual = {float(np.asarray(nr)[0]):.6e} / "
          f"{float(np.asarray(nb)[0]):.6e}")
    print(f"iterations: {int(res.iterations)}")
    return 0 if (bool(np.asarray(res.converged).all()) or rel <= 1e-2) else 1


if __name__ == "__main__":
    sys.exit(main())
