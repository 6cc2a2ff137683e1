"""Batched SpMV format tests against scipy ground truth."""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest

from hpddm_tpu.core.csr import MatrixCSR
from hpddm_tpu.core.formats import pack_local_matrices, batched_dense_from
from hpddm_tpu.ops.spmv import spmm


def _random_mats(S, n_range, density, seed, sym=False):
    rng = np.random.default_rng(seed)
    mats = []
    for s in range(S):
        n = rng.integers(*n_range)
        m = sp.random(n, n, density=density, random_state=int(rng.integers(1 << 30)),
                      format="csr")
        m = m + sp.identity(n)  # ensure nonzero diagonal
        if sym:
            full = m + m.T
            lower = sp.tril(full).tocsr()
            mats.append(MatrixCSR(lower, sym=True))
        else:
            mats.append(MatrixCSR(m))
    return mats


@pytest.mark.parametrize("fmt", ["dia", "ell", "dense"])
def test_spmm_matches_scipy(fmt):
    mats = _random_mats(3, (20, 40), 0.1, seed=1)
    n_max = max(m.n for m in mats)
    A = pack_local_matrices(mats, fmt=fmt)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, n_max, 2))
    y = np.asarray(spmm(A, jnp.asarray(x)))
    for s, m in enumerate(mats):
        expected = m.scipy() @ x[s, : m.n]
        np.testing.assert_allclose(y[s, : m.n], expected, atol=1e-12)


def test_symmetric_storage_expansion():
    mats = _random_mats(2, (15, 25), 0.15, seed=3, sym=True)
    n_max = max(m.n for m in mats)
    A = pack_local_matrices(mats, fmt="ell")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, n_max, 1))
    y = np.asarray(spmm(A, jnp.asarray(x)))
    for s, m in enumerate(mats):
        expected = m.scipy(expand=True) @ x[s, : m.n]
        np.testing.assert_allclose(y[s, : m.n], expected, atol=1e-12)


def test_dense_materialization_consistency():
    mats = _random_mats(2, (10, 20), 0.2, seed=5)
    for fmt in ("dia", "ell", "dense"):
        A = pack_local_matrices(mats, fmt=fmt)
        D = np.asarray(batched_dense_from(A))
        for s, m in enumerate(mats):
            np.testing.assert_allclose(D[s, : m.n, : m.n], m.dense(),
                                       atol=1e-12)
            # padding is identity
            for i in range(m.n, D.shape[1]):
                assert D[s, i, i] == 1.0


def test_csr_file_roundtrip(tmp_path):
    mats = _random_mats(1, (12, 13), 0.3, seed=6)
    path = str(tmp_path / "mat.txt")
    mats[0].dump(path)
    back = MatrixCSR.from_file(path)
    np.testing.assert_allclose(back.dense(), mats[0].dense(), atol=1e-14)


def test_canvas_dia_matches_flat():
    """The 2-D canvas SpMM (BatchedDIA.canvas_hw, attached by
    Schwarz.set_grid_geometry on uniform grid decompositions) must match
    the flat DIA product exactly for mu = 1 and mu > 1, and the attach
    gate must decline non-grid matrices (seam couplings)."""
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz
    from hpddm_tpu.ops.spmv import spmm_dia

    S, Nx, Ny = 4, 64, 64
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1,
                                       dtype=np.float64)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    A = sch.A
    assert A.canvas_hw is not None
    rng = np.random.default_rng(0)
    for mu in (1, 3):
        x = jnp.asarray(rng.normal(size=(S, sch.n_max, mu)))
        np.testing.assert_array_equal(np.asarray(spmm(A, x)),
                                      np.asarray(spmm_dia(A, x)))

    # the reference-faithful generator (seam quirks / nonuniform local
    # sizes) must not be annotated
    gen2 = diffusion2d.generate(4, 100, 100, overlap=1)
    sch2 = Schwarz(gen2.mats, gen2.neighbors, gen2.mappings, d=gen2.d,
                   options=Options())
    sch2.set_grid_geometry(gen2.boxes, 100, 100)
    assert sch2.A.canvas_hw is None


def test_canvas_symmetry_elision_bitwise(monkeypatch):
    """HPDDM_TPU_CANVAS_SYM=1: transpose-plane elision (the canvas SpMM
    never reads the negative-move planes of an exactly symmetric matrix)
    is bitwise-identical to the full product. Default-off (measured slower
    at flagship scale, PERF.md round 3) but kept correct."""
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz
    from hpddm_tpu.ops.spmv import spmm_dia

    monkeypatch.setenv("HPDDM_TPU_CANVAS_SYM", "1")
    S, Nx, Ny = 4, 64, 64
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1,
                                       dtype=np.float64)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    A = sch.A
    assert A.canvas_sym is not None and any(
        s is not None for s in A.canvas_sym)
    rng = np.random.default_rng(1)
    for mu in (1, 2):
        x = jnp.asarray(rng.normal(size=(S, sch.n_max, mu)))
        np.testing.assert_array_equal(np.asarray(spmm(A, x)),
                                      np.asarray(spmm_dia(A, x)))


def test_gmv_dtype_bf16_mirror():
    """-hpddm_gmv_dtype bfloat16: the SpMM hot path reads the low-precision
    mirror (accumulating in the vector dtype); setup keeps full values."""
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, gmv as _gmv

    S, Nx, Ny = 4, 64, 64
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1,
                                       dtype=np.float32)
    sch32 = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                    options=Options())
    schbf = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                    options=Options(gmv_dtype="bfloat16"))
    for s in (sch32, schbf):
        s.set_grid_geometry(gen.boxes, Nx, Ny)
    assert schbf.A.values_lp is not None
    assert schbf.A.values_lp.dtype == jnp.bfloat16
    assert schbf.A.values.dtype == jnp.float32     # setup path untouched
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(S, sch32.n_max, 1)).astype(np.float32))
    y32 = np.asarray(_gmv(sch32.operator_state(), x), dtype=np.float64)
    ybf = np.asarray(_gmv(schbf.operator_state(), x), dtype=np.float64)
    rel = np.linalg.norm(ybf - y32) / np.linalg.norm(y32)
    assert rel < 1e-2, rel                         # bf16 epsilon ~ 8e-3
    assert rel > 0                                 # mirror actually used


@pytest.mark.parametrize("S,Nx,Ny", [(4, 40, 40), (2, 100, 60)])
@pytest.mark.parametrize("mu", [1, 3, 4])
def test_flat_dia_spmm_matches_scipy(S, Nx, Ny, mu):
    """The flat (non-canvas) DIA SpMM of a grid operator without a
    ``set_grid_geometry`` annotation — the product the oracle runs —
    against each subdomain's scipy CSR product."""
    from hpddm_tpu.core.formats import BatchedDIA
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz

    gen = diffusion2d.generate(S, Nx, Ny, overlap=1)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    A = sch.operator_state().A
    assert isinstance(A, BatchedDIA) and A.canvas_hw is None
    x = np.random.default_rng(0).normal(size=(S, sch.n_max, mu))
    y = np.asarray(spmm(A, jnp.asarray(x)))
    for s, m in enumerate(gen.mats):
        ref = m.scipy(expand=True) @ x[s, : m.n]
        np.testing.assert_allclose(y[s, : m.n], ref, rtol=1e-12,
                                   atol=1e-11)
