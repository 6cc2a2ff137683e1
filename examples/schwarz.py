#!/usr/bin/env python
"""Canonical Schwarz driver — the analogue of examples/schwarz.{cpp,py} in
the reference, with the same command-line surface:

    python examples/schwarz.py -N 4 -hpddm_schwarz_method ras \
        -hpddm_schwarz_coarse_correction deflated -hpddm_geneo_nu 10 \
        -hpddm_tol 1e-6 -Nx 100 -Ny 100 -overlap 1 [-symmetric_csr 1] \
        [-generate_random_rhs 4] [-nonuniform 1] [-hpddm_verbosity 2]

Instead of one process per subdomain (mpirun -n 4), -N picks the number of
subdomains; they run batched on one chip or sharded over all available
devices with --mesh. Exits non-zero unless the reference's oracles hold
(iterations <= 45, independently recomputed residual <= 1e-2 —
examples/schwarz.cpp:140-143)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("N=<4>", "Number of subdomains."),
           ("Nx=<100>", "Number of grid points in the x-direction."),
           ("Ny=<100>", "Number of grid points in the y-direction."),
           ("overlap=<1>", "Number of grid points in the overlap."),
           ("generate_random_rhs=<0>", "Number of random right-hand sides."),
           ("symmetric_csr=(0|1)", "Assemble symmetric matrices."),
           ("nonuniform=(0|1)", "Different numbers of eigenpairs per subdomain."),
           ("mesh=(0|1)", "Shard subdomains over all available devices.")]
    opt = Options.parse(argv, display=True, app_options=app)
    S = int(opt.app()["N"])
    Nx, Ny = int(opt.app()["Nx"]), int(opt.app()["Ny"])
    overlap = int(opt.app()["overlap"])
    mu = int(opt.app()["generate_random_rhs"])
    sym = bool(opt.app().get("symmetric_csr", 0))
    verbosity = int(opt.val("verbosity", 0))

    # f64 on the CPU, f32 on the GPU; the oracles hold in both at tol 1e-6
    dtype = working_dtype()

    two_level = opt.set("schwarz_coarse_correction")
    gen = diffusion2d.generate(S, Nx, Ny, overlap=overlap, sym=sym, mu=mu,
                               with_neumann=two_level, dtype=dtype)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    if opt.val("local_solver", default="dense") == "fft":
        sch.set_grid_geometry(gen.boxes, Nx, Ny)
    f = np.zeros((S, sch.n_max, max(mu, 1)), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = jnp.asarray(f)
    if mu != 0:
        f = sch.exchange_rhs(f)

    if two_level:
        nu = int(opt.val("geneo_nu"))
        if nu > 0:
            nu_req = np.full(S, nu)
            if opt.app().get("nonuniform"):
                nu_req += np.maximum(-nu_req + 1,
                                     np.array([(-1) ** r * r for r in range(S)]))
                if S > 4:
                    nu_req[4] = 0
            nu_loc = sch.solve_gevp(gen.neumann, nu=nu_req)
            if verbosity:
                print(f"GenEO: nu per subdomain = {nu_loc.tolist()}")
        else:
            sch.set_vectors([np.ones((m.n, 1)) for m in gen.mats])

    state = sch.build()
    if opt.app().get("mesh") and len(jax.devices()) > 1 and \
            S % len(jax.devices()) == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from hpddm_tpu.parallel.mesh import make_mesh, shard_state, \
            sharded_solve
        mesh = make_mesh()
        state_sh = shard_state(state, mesh)
        f_sh = jax.device_put(f, NamedSharding(mesh, P("sub", None, None)))
        res = sharded_solve(state_sh, f_sh, opt, mesh)
        res_x = jnp.asarray(np.asarray(res.x))
    else:
        res = solve(state, f, opt=opt)
        res_x = res.x

    nb, nr = compute_residual(state, res_x, f)
    it = int(res.iterations)
    rel = np.asarray(nr) / np.asarray(nb)
    for nu_i, r in enumerate(rel):
        lead = " --- residual = " if nu_i == 0 else "                "
        tail = f" (rhs #{nu_i + 1})" if len(rel) > 1 else ""
        print(f"{lead}{float(np.asarray(nr)[nu_i]):.6e} / "
              f"{float(np.asarray(nb)[nu_i]):.6e}{tail}")
    if verbosity:
        print(f"GMRES converges after {it} iteration"
              + ("s" if it != 1 else ""))
    if verbosity >= 2 and getattr(res, "history", None) is not None:
        h = np.asarray(res.history)
        for i, v in enumerate(h[:, 0]):
            if v >= 0:
                print(f"  it {i:4d}  rel res {v:.6e}")

    cap = 60 if opt.val("krylov_method") == "bfbcg" else 45
    if it > cap:
        return 1
    if np.any(rel > 1.0e-2):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
