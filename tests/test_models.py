"""Helmholtz (complex, ORAS, GCRO-DR) and heterogeneous elasticity
(two-level GenEO-RAS + BGMRES) — the BASELINE.md workload configs 4-5."""

import numpy as np
import jax.numpy as jnp
import pytest

from hpddm_tpu.models import helmholtz, elasticity2d
from hpddm_tpu.options import Options
from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
from hpddm_tpu.solvers.krylov import solve


def _pack_f(gen, sch, S, dtype=None):
    f = np.zeros((S, sch.n_max, 1),
                 dtype=dtype if dtype is not None else gen.f[0].dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return jnp.asarray(f)


def test_complex_gmres():
    """Complex-arithmetic GMRES sanity (K = complex<double>)."""
    import scipy.sparse as sp
    from hpddm_tpu.solvers.base import LinearOperator
    from hpddm_tpu.solvers.gmres import gmres
    n = 50
    rng = np.random.default_rng(0)
    A = sp.diags([np.full(n - 1, -1.0), 4.0 + 1j * rng.normal(size=n),
                  np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr()
    b = (rng.normal(size=(1, n, 1)) + 1j * rng.normal(size=(1, n, 1)))
    Ad = jnp.asarray(A.todense())
    op = LinearOperator(gmv=lambda x: jnp.einsum("nk,skm->snm", Ad, x))
    res = gmres(op, jnp.asarray(b), tol=1e-10, restart=60, max_it=200)
    x = np.asarray(res.x)[0, :, 0]
    r = b[0, :, 0] - A @ x
    assert np.linalg.norm(r) / np.linalg.norm(b[0, :, 0]) < 1e-8


def test_helmholtz_oras_beats_ras():
    """ORAS with Robin interface conditions must beat plain RAS on *pure*
    (undamped) Helmholtz — the point of optimized Schwarz methods. At
    k=6, eps=0: RAS does not converge in 500 iterations, ORAS does in
    ~105."""
    S = 4
    gen = helmholtz.generate(S, Nx=60, Ny=60, k=6.0, eps=0.0)
    f = None
    its = {}
    for method, use_opt in (("ras", False), ("oras", True)):
        opt = Options(schwarz_method=method, tol=1e-8, max_it=300,
                      gmres_restart=200)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt,
                      optimized_mats=gen.oras_mats if use_opt else None)
        if f is None:
            f = _pack_f(gen, sch, S, dtype=np.complex128)
        state = sch.build()
        res = solve(state, f, opt=opt)
        its[method] = int(res.iterations)
        if method == "oras":
            nb, nr = compute_residual(state, res.x, f)
            assert float(np.abs(nr[0] / nb[0])) < 1e-2
    assert its["oras"] < its["ras"], its


def test_helmholtz_gcrodr_sequence():
    """Helmholtz + GCRO-DR recycling over a frequency sweep (BASELINE
    config 5). With the strong ORAS preconditioner the spectrum is already
    clustered, so the assertion is convergence + no material regression;
    the deflation *gain* is asserted on the restart-constrained case in
    tests/test_block_gcrodr.py (GMRES(10) stagnates at 2000 its where
    GCRODR converges in ~320)."""
    from hpddm_tpu.solvers.krylov import make_operator
    from hpddm_tpu.solvers.gcrodr import gcrodr
    from hpddm_tpu.solvers.gmres import gmres
    S = 4
    ks = [4.0, 4.05, 4.1]
    totals = {"gmres": 0, "gcrodr": 0}
    rec = None
    for k in ks:
        gen = helmholtz.generate(S, Nx=40, Ny=40, k=k, eps=0.3)
        opt = Options(schwarz_method="oras")
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, optimized_mats=gen.oras_mats)
        f = _pack_f(gen, sch, S, dtype=np.complex128)
        state = sch.build()
        op = make_operator(state)
        rg = gmres(op, f, tol=1e-8, restart=30, max_it=300)
        totals["gmres"] += int(rg.iterations)
        rr = gcrodr(op, f, tol=1e-8, restart=30, max_it=300, recycle=10,
                    recycled=rec)
        rec = rr.recycled
        assert bool(np.asarray(rr.converged).all())
        totals["gcrodr"] += int(rr.iterations)
    assert totals["gcrodr"] <= totals["gmres"] + 10, totals


def test_elasticity_two_level_bgmres():
    """Heterogeneous elasticity: two-level GenEO-RAS + block GMRES
    (BASELINE config 4). GenEO must cut iterations vs one-level."""
    S = 4
    gen, neumann, rbm = elasticity2d.generate(S, Nx=20, Ny=20,
                                              contrast=1e3, overlap=2)
    f = None
    its = {}
    for nu in (0, 10):
        kwargs = dict(tol=1e-6, max_it=300, gmres_restart=150,
                      krylov_method="bgmres")
        if nu:
            kwargs.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
        opt = Options(**kwargs)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        if f is None:
            rng = np.random.default_rng(1)
            fg = np.zeros((S, sch.n_max, 2))
            for s in range(S):
                fg[s, : gen.n_loc[s], 0] = gen.f[s][:, 0]
                fg[s, : gen.n_loc[s], 1] = rng.normal(size=gen.n_loc[s])
            f = sch.exchange_rhs(jnp.asarray(fg))
        if nu:
            sch.solve_gevp(neumann)
        state = sch.build()
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        rel = np.asarray(nr) / np.asarray(nb)
        assert np.all(rel < 1e-2), (nu, rel)
        its[nu] = int(res.iterations)
    assert its[10] < its[0], its


def test_helmholtz_real_pair_matches_complex():
    """helmholtz.generate(as_real=True): the real-pair solve must
    reproduce the complex solve (z = x[:n] + i x[n:])."""
    import jax.numpy as jnp
    from hpddm_tpu.models import helmholtz
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.solvers.krylov import solve

    S = 4
    sols = {}
    for as_real in (False, True):
        gen = helmholtz.generate(S, Nx=40, Ny=40, k=5.0, eps=0.05,
                                 as_real=as_real)
        opt = Options(tol=1e-10, max_it=400, gmres_restart=200,
                      schwarz_method="oras")
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, optimized_mats=gen.oras_mats)
        f = np.zeros((S, sch.n_max, 1),
                     dtype=np.float64 if as_real else np.complex128)
        for s in range(S):
            f[s, : gen.mats[s].n] = np.asarray(gen.f[s]).reshape(-1, 1)
        st = sch.build()
        res = solve(st, jnp.asarray(f), opt=opt)
        nb, nr = compute_residual(st, res.x, jnp.asarray(f))
        assert float(np.asarray(nr)[0] / np.asarray(nb)[0]) < 1e-8
        sols[as_real] = np.asarray(res.x)
    # compare on subdomain 0's owned dofs: complex z vs [Re; Im] halves
    n0 = sols[False].shape[1]
    zc = sols[False][0, :, 0]
    zr = sols[True][0, :, 0]
    n_half = 0
    from hpddm_tpu.models import helmholtz as _h  # noqa: F401
    # the real-pair layout doubles each subdomain: first half Re, second Im
    n_half = zr.shape[0] // 2
    z_pair = zr[:n_half] + 1j * zr[n_half:]
    np.testing.assert_allclose(z_pair[:n0], zc, rtol=1e-6, atol=1e-8)


def test_helmholtz_chip_anchor_twin():
    """Iteration anchors of the 60^2/k=6 undamped ORAS problem (the
    Helmholtz problem chip_smoke.py's breadth phase solves).

    On the CPU backend it takes 100 oras iterations in native c128 and
    194 in the f32 real-pair form (the real-pair form needs about twice
    the iterations of the complex one); this test fails if either anchor
    moves."""
    import jax.numpy as jnp
    from hpddm_tpu.models import helmholtz
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz
    from hpddm_tpu.solvers.krylov import solve

    its = {}
    for label, as_real, dt, fdt in [
            ("c128", False, np.complex128, np.complex128),
            ("realpair-f32", True, np.complex64, np.float32)]:
        gen = helmholtz.generate(4, Nx=60, Ny=60, k=6.0, eps=0.0,
                                 as_real=as_real, dtype=dt)
        opt = Options(tol=1e-6, max_it=500, gmres_restart=200,
                      schwarz_method="oras")
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, optimized_mats=gen.oras_mats)
        f = np.zeros((4, sch.n_max, 1), dtype=fdt)
        for s in range(4):
            f[s, : gen.mats[s].n] = np.asarray(gen.f[s]).reshape(-1, 1)
        res = solve(sch.build(), jnp.asarray(f), opt=opt)
        its[label] = int(res.iterations)
    assert its["c128"] == 100, its
    assert its["realpair-f32"] == 194, its
