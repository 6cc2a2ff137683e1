"""Block-tridiagonal local solver (-hpddm_local_solver banded): exact on
heterogeneous grid subdomains (unlike the DST fast solver), iteration
parity with batched dense inverses, and the block-tridiagonal structure
check."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from hpddm_tpu.models import diffusion2d
from hpddm_tpu.ops.banded_solve import build_banded_solver
from hpddm_tpu.options import Options
from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
from hpddm_tpu.solvers.krylov import solve


def _hetero_gen(S=4, Nx=64, Ny=64, contrast=1e3):
    def kappa(x, y):
        # high-contrast horizontal channels (the PERF.md flagship field)
        return np.where((np.floor(y * 1.7) % 2) == 0, contrast, 1.0)
    return diffusion2d.generate_uniform(S, Nx, Ny, overlap=2, kappa=kappa,
                                        with_neumann=True)


def test_banded_solve_exact():
    """The banded solve must match a direct sparse solve to f64 roundoff."""
    gen = _hetero_gen()
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d)
    solver = build_banded_solver(gen.mats, gen.boxes, sch.n_max,
                                 dtype=jnp.float64)
    rng = np.random.default_rng(0)
    b = np.zeros((len(gen.mats), sch.n_max, 2))
    for s in range(len(gen.mats)):
        b[s, : gen.n_loc[s]] = rng.normal(size=(gen.n_loc[s], 2))
    x = np.asarray(solver.solve(jnp.asarray(b)))
    for s in range(len(gen.mats)):
        K = gen.mats[s].scipy(expand=True)
        ref = sp.linalg.spsolve(K.tocsc(), b[s, : gen.n_loc[s], 0])
        np.testing.assert_allclose(x[s, : gen.n_loc[s], 0], ref,
                                   rtol=1e-9, atol=1e-9 * np.abs(ref).max())


def test_banded_iteration_parity_with_dense():
    """RAS + GMRES with banded local solves = same iterates as exact dense
    inverses (both are exact solves of the same local matrices)."""
    gen = _hetero_gen(Nx=48, Ny=48)
    S = len(gen.mats)
    its = {}
    for kind in ("inv", "banded"):
        opt = Options(tol=1e-8, max_it=200, local_solver=kind)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        sch.set_grid_geometry(gen.boxes, 48, 48)
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        f = sch.exchange_rhs(jnp.asarray(f))
        state = sch.build()
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        assert float(nr[0] / nb[0]) < 1e-6
        its[kind] = int(res.iterations)
    assert its["banded"] == its["inv"], its


def test_banded_dense_coupling_9point():
    """Non-diagonal adjacent-row coupling (9-point-like) switches to the
    dense coupling-block mode and stays exact."""
    n = 16
    A = sp.diags([np.ones(n - 3), -np.ones(n - 1), 8 * np.ones(n),
                  -np.ones(n - 1), np.ones(n - 3)],
                 [-3, -1, 0, 1, 3]).tocsr()

    class M:
        def scipy(self, expand=True):
            return A
    solver = build_banded_solver([M()], [(0, 4, 0, 4)], 16,
                                 dtype=jnp.float64)
    assert solver.cl.ndim == 4          # dense coupling blocks
    rng = np.random.default_rng(0)
    b = rng.normal(size=(1, 16, 1))
    x = np.asarray(solver.solve(jnp.asarray(b)))[0, :, 0]
    ref = sp.linalg.spsolve(A.tocsc(), b[0, :, 0])
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)


def test_banded_rejects_wide_coupling():
    """Coupling two grid rows apart is not block-tridiagonal: raise."""
    n = 16
    A = sp.diags([np.ones(n - 8), -np.ones(n - 1), 4 * np.ones(n),
                  -np.ones(n - 1), np.ones(n - 8)],
                 [-8, -1, 0, 1, 8]).tocsr()

    class M:
        def scipy(self, expand=True):
            return A
    with pytest.raises(ValueError):
        build_banded_solver([M()], [(0, 4, 0, 4)], 16)


def test_banded_two_level_geneo():
    """banded + GenEO (Lanczos GEVP path) beats one-level on contrast."""
    gen = _hetero_gen(Nx=64, Ny=64, contrast=1e3)
    S = len(gen.mats)
    its = {}
    for nu in (0, 8):
        kwargs = dict(tol=1e-8, max_it=300, local_solver="banded")
        if nu:
            kwargs.update(schwarz_coarse_correction="deflated", geneo_nu=nu)
        opt = Options(**kwargs)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        sch.set_grid_geometry(gen.boxes, 64, 64)
        f = None
        fg = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            fg[s, : gen.n_loc[s]] = gen.f[s]
        f = sch.exchange_rhs(jnp.asarray(fg))
        if nu:
            sch.solve_gevp(gen.neumann, method="lanczos")
        state = sch.build()
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        assert float(nr[0] / nb[0]) < 1e-6
        its[nu] = int(res.iterations)
    assert its[8] < its[0], its


def test_banded_3d_plane_blocked():
    """3D boxes: plane-major local ordering makes the 7-point operator
    block-tridiagonal in z-planes — banded local solves must match the
    batched dense inverses (set_banded_shapes(rows=wz, cols=wx*wy))."""
    from hpddm_tpu.models import diffusion3d
    S, Nx = 8, 16
    gen = diffusion3d.generate_uniform(S, Nx, Nx, Nx, overlap=1)
    shapes = [(k1 - k0, (i1 - i0) * (j1 - j0))
              for (i0, i1, j0, j1, k0, k1) in gen.boxes]
    its = {}
    for kind in ("inv", "banded"):
        opt = Options(tol=1e-8, max_it=200, local_solver=kind)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        if kind == "banded":
            sch.set_banded_shapes(shapes)
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        f = sch.exchange_rhs(jnp.asarray(f))
        state = sch.build()
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        assert float(nr[0] / nb[0]) < 1e-6
        its[kind] = int(res.iterations)
    assert its["banded"] == its["inv"], its


def test_banded_block_rows_end_to_end():
    """rows_per_block > 1 (corner-coupled blocks): identical iterates."""
    gen = _hetero_gen(Nx=48, Ny=48)
    S = len(gen.mats)
    its = {}
    for r in (1, 3):
        opt = Options(tol=1e-8, max_it=200, local_solver="banded",
                      banded_block_rows=r)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        sch.set_grid_geometry(gen.boxes, 48, 48)
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        f = sch.exchange_rhs(jnp.asarray(f))
        state = sch.build()
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        assert float(nr[0] / nb[0]) < 1e-6
        its[r] = int(res.iterations)
    assert its[3] == its[1], its


def test_banded_dense_coupling_elasticity():
    """2D elasticity on node-slab subdomains: Q1 node blocks make the
    inter-row coupling dense (2x2 per node, plus diagonal neighbors) —
    the dense-coupling banded mode must match exact dense inverses."""
    from hpddm_tpu.models import elasticity2d
    S, Nx = 4, 24
    gen, neumann, rbm = elasticity2d.generate(
        S, Nx=Nx, Ny=Nx, contrast=1e2, overlap=1,
        owner_fn=lambda ix, iy: min(ix * S // Nx, S - 1))
    shapes = []
    for s in range(S):
        nodes = np.unique(gen.gids[s] // 2)
        ix, iy = nodes % Nx, nodes // Nx
        wx = int(ix.max() - ix.min() + 1)
        wy = int(iy.max() - iy.min() + 1)
        assert gen.n_loc[s] == 2 * wx * wy     # rectangular node slabs
        shapes.append((wy, 2 * wx))
    its = {}
    for kind in ("inv", "banded"):
        opt = Options(tol=1e-8, max_it=400, gmres_restart=200,
                      local_solver=kind)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        if kind == "banded":
            sch.set_banded_shapes(shapes)
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s], 0] = gen.f[s][:, 0]
        f = sch.exchange_rhs(jnp.asarray(f))
        state = sch.build()
        if kind == "banded":
            assert state.solver.cl.ndim == 4   # dense coupling engaged
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        assert float(nr[0] / nb[0]) < 1e-5
        its[kind] = int(res.iterations)
    # both are exact local solves; the *dense inverse* side carries the
    # larger roundoff on the penalty-clamped (cond ~ 1e10) blocks, so
    # iteration counts may wiggle slightly — no blow-up allowed
    assert abs(its["banded"] - its["inv"]) <= 5, its


def test_factor_cache_round_trip(tmp_path, monkeypatch):
    """HPDDM_TPU_FACTOR_CACHE: the reloaded factors must be bit-identical
    to a fresh build (they are stored rounded), keyed by matrix content."""
    import os
    import numpy as np
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.ops.banded_solve import build_banded_solver

    gen = diffusion2d.generate_uniform(4, 48, 48, overlap=1)
    n_max = max(m.n for m in gen.mats)
    monkeypatch.setenv("HPDDM_TPU_FACTOR_CACHE", str(tmp_path))
    s1 = build_banded_solver(gen.mats, gen.boxes, n_max, dtype=jnp.float64)
    assert len(os.listdir(tmp_path)) == 1
    s2 = build_banded_solver(gen.mats, gen.boxes, n_max, dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(s1.Dinv), np.asarray(s2.Dinv))
    b = jnp.asarray(np.random.default_rng(0).normal(size=(4, n_max, 1)))
    np.testing.assert_array_equal(np.asarray(s1.solve(b)),
                                  np.asarray(s2.solve(b)))
    # a different matrix must miss the cache (content-keyed)
    gen2 = diffusion2d.generate_uniform(4, 48, 48, overlap=1)
    gen2.mats[0].scipy()  # same content -> same key; now perturb
    import scipy.sparse as sp
    from hpddm_tpu.core.csr import MatrixCSR
    m0 = gen2.mats[0].scipy(expand=True).tocsr() * 1.5
    mats2 = [MatrixCSR(sp.csr_matrix(m0))] + list(gen2.mats[1:])
    build_banded_solver(mats2, gen2.boxes, n_max, dtype=jnp.float64)
    assert len(os.listdir(tmp_path)) == 2


def test_device_factor_matches_host_f64():
    """method="device" (jitted lax.scan Schur recursion) must reproduce
    the host-f64 factors exactly when run in f64 (same algorithm, newton
    polish is a no-op at the f64 fixed point)."""
    gen = _hetero_gen(Nx=48, Ny=48)
    n_max = max(m.n for m in gen.mats)
    sh = build_banded_solver(gen.mats, gen.boxes, n_max, dtype=jnp.float64,
                             method="host")
    sd = build_banded_solver(gen.mats, gen.boxes, n_max, dtype=jnp.float64,
                             method="device")
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=(len(gen.mats), n_max, 2)))
    xh = np.asarray(sh.solve(b))
    xd = np.asarray(sd.solve(b))
    np.testing.assert_allclose(xd, xh, rtol=1e-12, atol=1e-12)


def test_device_factor_f32_accuracy():
    """f32 device factorization (the GPU path): the factors must solve the
    local systems to ~f32 accuracy — per-step f32 errors must not compound
    through the recursion (heterogeneous contrast, Jacobi-scaled-like)."""
    gen = _hetero_gen(Nx=64, Ny=64, contrast=1e3)
    n_max = max(m.n for m in gen.mats)
    sd = build_banded_solver(gen.mats, gen.boxes, n_max, dtype=jnp.float32,
                             method="device")
    rng = np.random.default_rng(1)
    b = np.zeros((len(gen.mats), n_max, 1), dtype=np.float32)
    for s in range(len(gen.mats)):
        b[s, : gen.n_loc[s], 0] = rng.normal(size=gen.n_loc[s])
    x = np.asarray(sd.solve(jnp.asarray(b))).astype(np.float64)
    for s in range(len(gen.mats)):
        K = gen.mats[s].scipy(expand=True)
        xs = x[s, : gen.n_loc[s], 0]
        bs = b[s, : gen.n_loc[s], 0].astype(np.float64)
        rel = np.linalg.norm(K @ xs - bs) / np.linalg.norm(bs)
        assert rel < 5e-4, (s, rel)


def test_device_factor_dense_coupling():
    """Dense coupling blocks (9-point-like) through the device recursion."""
    n = 16
    A = sp.diags([np.ones(n - 3), -np.ones(n - 1), 8 * np.ones(n),
                  -np.ones(n - 1), np.ones(n - 3)],
                 [-3, -1, 0, 1, 3]).tocsr()

    class M:
        def scipy(self, expand=True):
            return A
    solver = build_banded_solver([M()], [(0, 4, 0, 4)], 16,
                                 dtype=jnp.float64, method="device")
    assert solver.cl.ndim == 4
    rng = np.random.default_rng(0)
    b = rng.normal(size=(1, 16, 1))
    x = np.asarray(solver.solve(jnp.asarray(b)))[0, :, 0]
    ref = sp.linalg.spsolve(A.tocsc(), b[0, :, 0])
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)


def test_device_factor_newton_chain(monkeypatch):
    """HPDDM_TPU_BANDED_CHAIN=1: the LU-free Newton-chained recursion
    (block j seeds from block j-1's inverse, diagonal-ratio rescaled)
    must match the host factors on an equilibrated flagship-like field;
    on raw rapidly-alternating contrast channels the chain diverges and
    the builder must silently fall back to the LU recursion."""
    from hpddm_tpu.core.scaling import jacobi_scale

    def kap(xx, yy):
        return (np.where((yy > 3.3) & (yy < 6.6), 1.0e3, 1.0)
                * np.where(xx > 5.0, 10.0, 1.0))

    gen = diffusion2d.generate_uniform(4, 64, 64, overlap=1, kappa=kap,
                                       with_neumann=True)
    mats, _, _, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    n_max = max(m.n for m in mats)
    monkeypatch.setenv("HPDDM_TPU_BANDED_CHAIN", "1")
    monkeypatch.setenv("HPDDM_TPU_BANDED_NEWTON", "8")
    sd = build_banded_solver(mats, gen.boxes, n_max, dtype=jnp.float64,
                             method="device")
    monkeypatch.delenv("HPDDM_TPU_BANDED_CHAIN")
    sh = build_banded_solver(mats, gen.boxes, n_max, dtype=jnp.float64,
                             method="host")
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=(len(mats), n_max, 1)))
    np.testing.assert_allclose(np.asarray(sd.solve(b)),
                               np.asarray(sh.solve(b)),
                               rtol=1e-10, atol=1e-10)

    # raw alternating channels: the chain diverges -> LU fallback, and
    # the returned factors must still be finite and correct
    monkeypatch.setenv("HPDDM_TPU_BANDED_CHAIN", "1")
    gen2 = _hetero_gen(Nx=48, Ny=48)
    n2 = max(m.n for m in gen2.mats)
    sf = build_banded_solver(gen2.mats, gen2.boxes, n2, dtype=jnp.float64,
                             method="device")
    monkeypatch.delenv("HPDDM_TPU_BANDED_CHAIN")
    s2 = build_banded_solver(gen2.mats, gen2.boxes, n2, dtype=jnp.float64,
                             method="host")
    b2 = jnp.asarray(rng.normal(size=(len(gen2.mats), n2, 1)))
    np.testing.assert_allclose(np.asarray(sf.solve(b2)),
                               np.asarray(s2.solve(b2)),
                               rtol=1e-10, atol=1e-10)


def test_chain_residual_probe_catches_bad_factors():
    """The chain validation probe (ADVICE r4): exact factors measure ~eps;
    finite-but-wrong factors measure large — the guard that replaces the
    old NaN-only fallback must separate the two."""
    import jax
    from hpddm_tpu.ops.banded_solve import (_chain_residual,
                                            _extract_blocks, _schur_host)

    gen = _hetero_gen(Nx=32, Ny=32)
    n_max = max(m.n for m in gen.mats)
    (D, cl, cu, *_rest, dense_mode, nbk, L, wx_max) = _extract_blocks(
        gen.mats, gen.boxes, n_max, None, 1)
    Dinv = _schur_host(D.copy(), cl, cu, dense_mode, wx_max)
    good = float(_chain_residual(jnp.asarray(Dinv), jnp.asarray(D),
                                 jnp.asarray(cl), jnp.asarray(cu),
                                 dense_mode=dense_mode, wx_max=wx_max))
    assert good < 1e-8, good          # f64 exact factors
    bad = Dinv * 1.05                 # finite, plausible-looking, wrong
    err = float(_chain_residual(jnp.asarray(bad), jnp.asarray(D),
                                jnp.asarray(cl), jnp.asarray(cu),
                                dense_mode=dense_mode, wx_max=wx_max))
    assert np.isfinite(err) and err > 1e-2, err
