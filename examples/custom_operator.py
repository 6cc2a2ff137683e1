#!/usr/bin/env python
"""Matrix-free solves through user callbacks (custom-operator parity).

Counterpart of the reference's ``HpddmCustomOperatorSolve``
C/Fortran examples (examples/custom_operator.c:34-53, custom_operator.f90):
the Krylov layer driven by a user ``mv``/``apply`` callback pair with no
assembled matrix anywhere. The operator is the reference's: on "rank" s of
S, out_i = (n*s + i + 2) x_i - 0.5 x_{i-1} - 0.5 x_{i+1} within the local
block, preconditioned by the diagonal inverse — except the S ranks are one
batched jnp program instead of MPI processes.

    python examples/custom_operator.py -n 100 -mu 2 -S 4 \\
        [-hpddm_krylov_method gmres|cg|bgmres|bcg|bfbcg|gcrodr ...]

Exits nonzero if the recomputed true residual misses the tolerance.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import jax.numpy as jnp
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.options import Options
    from hpddm_tpu.solvers.base import LinearOperator
    from hpddm_tpu.solvers.krylov import solve

    argv = list(sys.argv[1:] if argv is None else argv)
    app = [("n=<100>", "Size of the local operators."),
           ("mu=<2>", "Number of generated random right-hand sides."),
           ("S=<4>", "Number of batched \"ranks\".")]
    opt = Options.parse(argv, display=True, app_options=app)
    n = int(opt.app()["n"])
    mu = int(opt.app()["mu"])
    S = int(opt.app()["S"])
    dtype = working_dtype()

    diag = (np.arange(S)[:, None] * n + np.arange(n)[None, :] + 2.0)
    dj = jnp.asarray(diag.astype(dtype))

    def mv(x):
        up = jnp.concatenate([x[:, 1:, :], jnp.zeros_like(x[:, :1, :])],
                             axis=1)
        dn = jnp.concatenate([jnp.zeros_like(x[:, :1, :]), x[:, :-1, :]],
                             axis=1)
        return dj[:, :, None] * x - 0.5 * up - 0.5 * dn

    def prec(x):
        return x / dj[:, :, None]

    op = LinearOperator(gmv=mv, apply=prec)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.uniform(0.0, 100.0, (S, n, mu)).astype(dtype))
    res = solve(op, b, opt=opt)
    tol = float(opt.val("tol", 1.0e-6))
    # per-RHS gate (the reference checks convergence per right-hand side;
    # a Frobenius norm can hide one stalled column behind converged ones)
    r = mv(res.x) - b
    rel_cols = (jnp.linalg.norm(r.reshape(-1, mu), axis=0)
                / jnp.linalg.norm(b.reshape(-1, mu), axis=0))
    rel = float(jnp.max(rel_cols))
    print(f"{opt.val('krylov_method', 'gmres')}: {int(res.iterations)} "
          f"iterations, worst per-RHS true relative residual {rel:.2e}")
    return 0 if rel <= 100.0 * tol else 1


if __name__ == "__main__":
    sys.exit(main())
