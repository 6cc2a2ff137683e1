#!/usr/bin/env python
"""Helmholtz driver: ORAS with Robin interface conditions + optional
GCRO-DR recycling over a frequency sweep (BASELINE.md config 5).

    python examples/helmholtz.py -N 4 -Nx 60 -k 6.0 -eps 0.0 \
        [-sweep 3] [-hpddm_krylov_method gcrodr -hpddm_recycle 10]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import jax.numpy as jnp
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import helmholtz
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import make_operator, solve
    from hpddm_tpu.solvers.gcrodr import gcrodr

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("Nx=<60>", "Grid points per direction."),
           ("k=<6.0>", "Wavenumber."),
           ("eps=<0.0>", "Damping (0 = pure Helmholtz)."),
           ("sweep=<1>", "Number of wavenumbers (recycling across solves).")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    Nx = int(opt.app()["Nx"])
    k0 = float(opt.app()["k"])
    eps = float(opt.app()["eps"])
    sweep = int(opt.app()["sweep"])
    if not opt.set("schwarz_method"):
        opt["schwarz_method"] = "oras"
    if not opt.set("gmres_restart"):
        opt["gmres_restart"] = 200
    if not opt.set("max_it"):
        opt["max_it"] = 500

    total = 0
    rec = None
    use_recycling = opt.val("krylov_method") in ("gcrodr", "bgcrodr")
    cdt = working_dtype(complex_=True)
    for j in range(sweep):
        kj = k0 * (1.0 + 0.01 * j)
        gen = helmholtz.generate(
            S, Nx=Nx, Ny=Nx, k=kj, eps=eps, dtype=cdt)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, optimized_mats=gen.oras_mats)
        f = np.zeros((S, sch.n_max, 1), dtype=cdt)
        for s in range(S):
            f[s, : gen.mats[s].n] = np.asarray(gen.f[s]).reshape(-1, 1)
        f = jnp.asarray(f)
        state = sch.build()
        if use_recycling:
            op = make_operator(state)
            res = gcrodr(op, f, tol=float(opt.val("tol")),
                         restart=int(opt.val("gmres_restart")),
                         max_it=int(opt.val("max_it")),
                         recycle=int(opt.val("recycle", 10)), recycled=rec)
            rec = res.recycled
        else:
            res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        it = int(res.iterations)
        total += it
        print(f"k = {kj:.3f}: {it} iterations, residual "
              f"{float(np.abs(nr[0])):.3e} / {float(np.abs(nb[0])):.3e}")
        if float(np.abs(nr[0] / nb[0])) > 1e-2:
            return 1
    if sweep > 1:
        print(f"total iterations: {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
