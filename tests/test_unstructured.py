"""Unstructured P1 FEM model + RCM banded local solves (round 5).

The reference is sparsity-agnostic (HPDDM_wrapper.hpp:617-680 csrmv;
generateFromFile.cpp partitions arbitrary matrices); VERDICT r4 missing #3
asked for a genuinely unstructured in-tree operator.  These tests pin:

* mesh/assembly sanity (SPD, boundary handling),
* GMV exactness of the algebraic decomposition vs the assembled matrix,
* RCM banded local solves == exact on unstructured matrices, composed
  with the interface-first renumbered layout,
* GenEO on FEM Neumann matrices cutting iterations,
* end-to-end true residuals on the global system.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hpddm_tpu.models import unstructured
from hpddm_tpu.options import Options
from hpddm_tpu.precond.schwarz import Schwarz, gmv
from hpddm_tpu.solvers.krylov import solve


@pytest.fixture(scope="module")
def gen():
    return unstructured.generate(8, 60, 60, overlap=2, with_neumann=True,
                                 seed=0)


def _rhs(gen, sch, S):
    f = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    return jnp.asarray(f)


def _true_relres(gen, sch, x):
    N = gen.A_global.shape[0]
    xs = np.asarray(x)
    xg = np.zeros(N)
    for s in range(len(gen.n_loc)):
        xg[gen.gids[s]] = xs[s, : gen.n_loc[s], 0]
    fg = np.where(gen.boundary, 0.0, 1.0)
    return np.linalg.norm(gen.A_global @ xg - fg) / np.linalg.norm(fg)


def test_mesh_and_matrix(gen):
    # every interior row has unstructured support (row lengths vary)
    K = gen.A_global
    counts = np.diff(K.indptr)
    interior = ~gen.boundary
    # rows next to the eliminated boundary can be short; >= 3 incl. diag
    assert counts[interior].min() >= 3
    assert len(np.unique(counts[interior])) >= 4      # genuinely irregular
    # no grid structure: many distinct column-offset patterns
    coo = K.tocoo()
    assert len(np.unique(coo.col - coo.row)) > 200
    # SPD on the free dofs
    sym_err = abs(K - K.T).max()
    assert sym_err < 1e-12


def test_gmv_exactness(gen):
    S = 8
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  renumber=True)
    state = sch.build()
    rng = np.random.default_rng(0)
    g = rng.normal(size=gen.A_global.shape[0])
    x = np.zeros((S, sch.n_max, 1))
    for s in range(S):
        x[s, : gen.n_loc[s], 0] = g[gen.gids[s]]
    y = np.asarray(state.dec.unpermute(
        gmv(state, state.dec.permute(jnp.asarray(x)))))
    ref = gen.A_global @ g
    for s in range(S):
        np.testing.assert_allclose(y[s, : gen.n_loc[s], 0],
                                   ref[gen.gids[s]], atol=1e-10)


def test_rcm_banded_exact(gen):
    from hpddm_tpu.ops.banded_solve import build_banded_solver_rcm
    n_max = max(gen.n_loc)
    solver, bws = build_banded_solver_rcm(gen.mats, n_max,
                                          dtype=jnp.float64)
    assert max(bws) < 120                  # RCM keeps FEM bandwidth small
    rng = np.random.default_rng(1)
    b = np.zeros((8, n_max, 2))
    for s in range(8):
        b[s, : gen.n_loc[s]] = rng.normal(size=(gen.n_loc[s], 2))
    x = np.asarray(solver.solve(jnp.asarray(b)))
    for s in range(8):
        K = gen.mats[s].scipy(expand=True)
        r = np.linalg.norm(K @ x[s, : gen.n_loc[s]] - b[s, : gen.n_loc[s]])
        assert r / np.linalg.norm(b[s, : gen.n_loc[s]]) < 1e-10


def test_one_level_vs_geneo(gen):
    S = 8
    its = {}
    for cc, nu in [(None, 0), ("deflated", 8)]:
        opt = Options(tol=1e-8, **({} if cc is None else dict(
            schwarz_coarse_correction=cc, geneo_nu=nu)))
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, renumber=True)
        if cc:
            sch.solve_gevp(gen.neumann)
        st = sch.build()
        res = solve(st, _rhs(gen, sch, S), opt=opt)
        assert _true_relres(gen, sch, res.x) < 5e-8
        its[cc] = int(res.iterations)
    assert its["deflated"] < its[None] <= 40
    assert its["deflated"] <= 20


def test_banded_lanczos_pipeline(gen):
    """The production unstructured config: renumbered layout + RCM banded
    factors + matrix-free Lanczos GenEO."""
    S = 8
    opt = Options(tol=1e-8, local_solver="banded",
                  schwarz_coarse_correction="deflated", geneo_nu=8)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt, renumber=True)
    sch.solve_gevp(gen.neumann, method="lanczos")
    st = sch.build()
    res = solve(st, _rhs(gen, sch, S), opt=opt)
    assert int(res.iterations) <= 20
    assert _true_relres(gen, sch, res.x) < 5e-8


def test_heterogeneous_graded(gen):
    """Contrast 1e4 + graded mesh: GenEO keeps the iteration count flat."""
    S = 8
    kap = (lambda x, y: np.where((y > 0.33) & (y < 0.66), 1e4, 1.0))
    g2 = unstructured.generate(S, 60, 60, overlap=2, kappa=kap,
                               grading=0.5, with_neumann=True, seed=1)
    opt = Options(tol=1e-8, schwarz_coarse_correction="deflated",
                  geneo_nu=10)
    sch = Schwarz(g2.mats, g2.neighbors, g2.mappings, d=g2.d,
                  options=opt, renumber=True)
    sch.solve_gevp(g2.neumann)
    st = sch.build()
    res = solve(st, _rhs(g2, sch, S), opt=opt)
    assert int(res.iterations) <= 25


def test_ell_spmm_matches_scipy(gen):
    """The XLA ELL SpMM (take_along_axis gather + row reduction) against
    each subdomain's scipy CSR product, two RHS."""
    from hpddm_tpu.core.formats import BatchedELL
    from hpddm_tpu.ops.spmv import spmm

    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d)
    assert isinstance(sch.A, BatchedELL)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, sch.n_max, 2))
    y = np.asarray(spmm(sch.A, jnp.asarray(x)))
    for s, m in enumerate(gen.mats):
        ref = m.scipy(expand=True) @ x[s, : m.n]
        np.testing.assert_allclose(y[s, : m.n], ref, rtol=1e-12,
                                   atol=1e-12)


def test_rcm_local_alignment(gen):
    """rcm_local keeps neighbor mappings elementwise-aligned: the mapped
    global ids must agree pairwise."""
    for s in range(8):
        for qi, q in enumerate(gen.neighbors[s]):
            si = gen.neighbors[q].index(s)
            gs = gen.gids[s][gen.mappings[s][qi]]
            gq = gen.gids[q][gen.mappings[q][si]]
            np.testing.assert_array_equal(gs, gq)


def test_general_exchange_matches_add_at(gen):
    """The general (caller-numbering) exchange: every copy of a shared
    dof ends up holding the sum of all copies — checked against a numpy
    ``np.add.at`` over the global ids of the subdomains."""
    from hpddm_tpu.parallel.ops import exchange

    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d)
    assert sch.dec.grid is None and not sch.dec.renumbered
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, sch.n_max, 2))
    y = np.asarray(exchange(sch.dec, jnp.asarray(x)))
    total = np.zeros((gen.A_global.shape[0], 2))
    for s in range(8):
        np.add.at(total, gen.gids[s], x[s, : gen.n_loc[s]])
    for s in range(8):
        np.testing.assert_allclose(y[s, : gen.n_loc[s]],
                                   total[gen.gids[s]], rtol=1e-12,
                                   atol=1e-12)


def test_unstructured_sharded_matches_batched(gen):
    """Unstructured (ELL, general-exchange) pipeline under shard_map must
    match the batched solve bitwise — the np>1 analogue for the
    algebraic path (architecture invariant, CLAUDE.md)."""
    import jax
    from hpddm_tpu.parallel.mesh import (make_mesh, shard_state,
                                         sharded_solve)

    S = 8
    opt = Options(tol=1e-8, schwarz_coarse_correction="deflated",
                  geneo_nu=6)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = _rhs(gen, sch, S)
    res_ref = solve(state, f, opt=opt)

    mesh = make_mesh(4)
    state_sh = shard_state(state, mesh)
    f_sh = jax.device_put(f, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("sub", None, None)))
    res_sh = sharded_solve(state_sh, f_sh, opt, mesh)
    assert int(res_sh.iterations) == int(res_ref.iterations)
    np.testing.assert_allclose(np.asarray(res_sh.x),
                               np.asarray(res_ref.x), atol=1e-10)


def test_unstructured_block_methods(gen):
    """True-block BGMRES mu=3 on the unstructured pipeline (ELL SpMM and
    general exchange) — per-RHS residual gates like the reference's block
    drivers."""
    from hpddm_tpu.precond.schwarz import compute_residual

    S = 8
    opt = Options(tol=1e-8, max_it=200, krylov_method="bgmres",
                  schwarz_coarse_correction="deflated", geneo_nu=6)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    sch.solve_gevp(gen.neumann)
    st = sch.build()
    rng = np.random.default_rng(7)
    f = np.zeros((S, sch.n_max, 3))
    for s in range(S):
        f[s, : gen.n_loc[s]] = rng.normal(size=(gen.n_loc[s], 3))
    f = sch.exchange_rhs(jnp.asarray(f))
    res = solve(st, f, opt=opt)
    nb, nr = compute_residual(st, res.x, f)
    rel = np.asarray(nr) / np.asarray(nb)
    assert np.all(rel < 1e-6), rel
    assert int(res.iterations) <= 60


def test_unstructured_3d_tets():
    """3-D tetrahedral P1 FEM (round 5): jittered 3-D Delaunay lattice,
    generalized simplex assembly (row sums zero pre-BC, SPD), balanced
    mesh-graph partition (the eliminated graph's edgeless boundary rows
    must not starve the partitioner), GenEO on tet Neumann matrices, true
    residuals on the assembled system."""
    S = 8
    gen = unstructured.generate(S, 14, 14, nz=14, overlap=2,
                                with_neumann=True, seed=0)
    sizes = np.array(gen.n_loc)
    assert sizes.max() < 2.0 * sizes.min()        # balanced parts
    N = gen.A_global.shape[0]
    its = {}
    for cc in (None, "deflated"):
        opt = Options(tol=1e-8, **({} if cc is None else dict(
            schwarz_coarse_correction=cc, geneo_nu=8)))
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt)
        if cc:
            sch.solve_gevp(gen.neumann)
        st = sch.build()
        res = solve(st, _rhs(gen, sch, S), opt=opt)
        xs = np.asarray(res.x)
        xg = np.zeros(N)
        for s in range(S):
            xg[gen.gids[s]] = xs[s, : gen.n_loc[s], 0]
        fg = np.where(gen.boundary, 0.0, 1.0)
        rel = np.linalg.norm(gen.A_global @ xg - fg) / np.linalg.norm(fg)
        assert rel < 5e-8, (cc, rel)
        its[cc] = int(res.iterations)
    assert its["deflated"] <= its[None] <= 25
