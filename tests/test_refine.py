"""Mixed-precision iterative refinement (solvers/refine.py).

IR with host-f64 residuals around the f32 device solve recovers
f64-grade true residuals. These tests run the same machinery on CPU with
an f32 inner solve.
"""

import numpy as np
import jax
import jax.numpy as jnp

from hpddm_tpu.core.scaling import jacobi_scale
from hpddm_tpu.models import diffusion2d
from hpddm_tpu.options import Options
from hpddm_tpu.precond.schwarz import Schwarz
from hpddm_tpu.solvers.krylov import solve
from hpddm_tpu.solvers.refine import solve_refined


def _kappa(xx, yy):
    return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
            * np.where(xx > 5.0, 10.0, 1.0))


def test_refinement_reaches_f64_grade_residual():
    S, Nx, Ny = 4, 64, 64
    dtype = np.float32
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, kappa=_kappa,
                                       dtype=dtype)
    mats, f_s, _, _ = jacobi_scale(gen.mats, gen.f)
    opt = Options(tol=1e-4)
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = f_s[s]
    solve_jit = jax.jit(lambda b: solve(state, jnp.asarray(b), opt=opt))
    x, info = solve_refined(solve_jit, mats, f, state.dec,
                            tol=1e-10, max_refine=8)
    # geometric per-pass contraction, final residual beyond f32 reach
    assert info["history"][-1] <= 1e-10
    assert len(info["inner_iterations"]) <= 6
    # solution is consistent across duplicated dofs (every copy holds the
    # same f64 value, not one rounded per copy by the f32 corrections)
    scale = np.abs(x).max()
    for s in range(S):
        for q, idx in zip(gen.neighbors[s], gen.mappings[s]):
            back = gen.mappings[q][gen.neighbors[q].index(s)]
            assert np.abs(x[s, idx, 0] - x[q, back, 0]).max() \
                <= 1e-14 * scale
    # ... and exact for the host operator: recompute the global residual
    # independently
    A0 = mats[0].scipy(expand=True)
    n0 = A0.shape[0]
    r0 = f_s[0][:, 0] - A0 @ x[0, :n0, 0]
    d0 = np.asarray(state.dec.d)[0, :n0]
    assert np.sqrt(np.sum(d0 * r0 * r0)) / np.linalg.norm(f_s[0]) < 1e-9


def test_refinement_averages_disagreeing_copies():
    """A device solve may return copies of a duplicated dof that agree
    only to its working precision (GPU reduction order); the refined
    solution must still be one global vector, or its global residual
    stalls where the per-copy residual measure cannot see it."""
    from types import SimpleNamespace

    S, Nx, Ny = 4, 48, 48
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, kappa=_kappa,
                                       dtype=np.float32)
    mats, f_s, _, _ = jacobi_scale(gen.mats, gen.f)
    opt = Options(tol=1e-4)
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=np.float32)
    for s in range(S):
        f[s, : gen.n_loc[s]] = f_s[s]
    solve_jit = jax.jit(lambda b: solve(state, jnp.asarray(b), opt=opt))
    rng = np.random.default_rng(0)

    def noisy_solve(b):
        res = solve_jit(b)
        x = np.asarray(res.x, dtype=np.float64)
        x = x * (1 + 1e-7 * rng.standard_normal(x.shape))
        return SimpleNamespace(x=x, iterations=res.iterations)

    x, info = solve_refined(noisy_solve, mats, f, state.dec, tol=1e-10,
                            max_refine=8)
    scale = np.abs(x).max()
    for s in range(S):
        for q, idx in zip(gen.neighbors[s], gen.mappings[s]):
            back = gen.mappings[q][gen.neighbors[q].index(s)]
            assert np.abs(x[s, idx, 0] - x[q, back, 0]).max() \
                <= 1e-14 * scale
    assert info["history"][-1] <= 1e-10


def test_refinement_history_is_monotone():
    S, Nx, Ny = 4, 48, 48
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1,
                                       dtype=np.float32)
    opt = Options(tol=1e-4)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=np.float32)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    solve_jit = jax.jit(lambda b: solve(state, jnp.asarray(b), opt=opt))
    x, info = solve_refined(solve_jit, gen.mats, f, state.dec,
                            tol=1e-11, max_refine=6)
    h = info["history"]
    assert all(h[i + 1] < h[i] for i in range(len(h) - 1))
    assert h[-1] < 1e-8


def test_device_dw_refinement_matches_host():
    """solve_refined_device: double-word f32 on-device residuals reach the
    same f64-grade floor as the host-f64 loop, no host SpMV anywhere."""
    from hpddm_tpu.solvers.refine import solve_refined_device
    S, Nx, Ny = 4, 64, 64
    dtype = np.float32
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, kappa=_kappa,
                                       dtype=dtype)
    mats, f_s, _, _ = jacobi_scale(gen.mats, gen.f)
    opt = Options(tol=1e-4)
    sch = Schwarz(mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = f_s[s]
    x, info = solve_refined_device(state, f, opt=opt, tol=1e-10,
                                   max_refine=8)
    assert info["history"][-1] <= 1e-10
    # independent host-f64 check of the device-computed solution
    A0 = mats[0].scipy(expand=True)
    n0 = A0.shape[0]
    r0 = f_s[0][:, 0] - A0 @ x[0, :n0, 0]
    d0 = np.asarray(state.dec.d)[0, :n0]
    assert np.sqrt(np.sum(d0 * r0 * r0)) / np.linalg.norm(f_s[0]) < 1e-9


def test_doubleword_primitives_exact():
    """2Sum/2Prod error-free transforms: pair sums reproduce the f64
    values exactly for f32 inputs."""
    from hpddm_tpu.ops.doubleword import two_sum, two_prod
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.normal(size=1000).astype(np.float32))
    b = jnp.asarray(rng.normal(size=1000).astype(np.float32) * 1e-5)
    s, e = two_sum(a, b)
    exact = (np.asarray(a, np.float64) + np.asarray(b, np.float64))
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact)
    p, pe = two_prod(a, b)
    exact = (np.asarray(a, np.float64) * np.asarray(b, np.float64))
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(pe, np.float64), exact)
