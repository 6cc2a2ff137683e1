"""Interface-first renumbering (the fast exchange path) must be
semantically identical to the original-numbering path."""

import numpy as np
import jax.numpy as jnp

from hpddm_tpu.models import diffusion2d
from hpddm_tpu.options import Options
from hpddm_tpu.parallel.decomposition import Decomposition
from hpddm_tpu.parallel.ops import exchange, scaled_exchange
from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
from hpddm_tpu.solvers.krylov import solve


def test_exchange_renumbered_equivalence():
    gen = diffusion2d.generate(4, 24, 24, overlap=2)
    dec0 = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                         gen.n_loc, d=gen.d, renumber=False)
    dec1 = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                         gen.n_loc, d=gen.d, renumber=True)
    rng = np.random.default_rng(0)
    x = np.zeros((4, dec0.n_max, 2))
    for s in range(4):
        x[s, : gen.n_loc[s]] = rng.normal(size=(gen.n_loc[s], 2))
    xj = jnp.asarray(x)
    out0 = np.asarray(exchange(dec0, xj))
    out1 = np.asarray(dec1.unpermute(exchange(dec1, dec1.permute(xj))))
    np.testing.assert_allclose(out0, out1, atol=1e-13)
    s0 = np.asarray(scaled_exchange(dec0, xj))
    s1 = np.asarray(dec1.unpermute(scaled_exchange(dec1, dec1.permute(xj))))
    np.testing.assert_allclose(s0, s1, atol=1e-13)
    # permute/unpermute round trip
    np.testing.assert_allclose(
        np.asarray(dec1.unpermute(dec1.permute(xj))), x, atol=0)


def test_solve_identical_iterations():
    """The renumbered pipeline must reproduce the solve exactly (the
    permutation is a similarity transform of the whole setup)."""
    S = 4
    gen = diffusion2d.generate(S, 40, 40, overlap=1, with_neumann=True)
    f0 = None
    results = {}
    for renum in (False, True):
        opt = Options(schwarz_coarse_correction="deflated", geneo_nu=4)
        sch = Schwarz.__new__(Schwarz)
        # construct manually to control renumber
        sch.opt = opt
        sch.dec = Decomposition.from_subdomains(
            gen.neighbors, gen.mappings, gen.n_loc, d=gen.d,
            renumber=renum)
        sch.mats = list(gen.mats)
        sch.n_max = sch.dec.n_max
        from hpddm_tpu.core.formats import pack_local_matrices
        sch.A = pack_local_matrices(sch._permuted(gen.mats),
                                    n_max=sch.n_max, fmt="auto")
        sch.optimized_mats = None
        sch._deflation_vectors = None
        sch._state = None
        sch.solve_gevp(gen.neumann)
        state = sch.build()
        f = np.zeros((S, sch.n_max, 1))
        for s in range(S):
            f[s, : gen.n_loc[s]] = gen.f[s]
        f = jnp.asarray(f)
        res = solve(state, f, opt=opt)
        nb, nr = compute_residual(state, res.x, f)
        results[renum] = (int(res.iterations), np.asarray(res.x),
                          float(nr[0] / nb[0]))
    assert results[False][0] == results[True][0]
    np.testing.assert_allclose(results[False][1], results[True][1],
                               atol=1e-8)
    assert results[True][2] < 1e-2
