#!/usr/bin/env python
"""Run the Schwarz -> Krylov path once on one GPU and check every phase.

    python chip_smoke.py            # phases 1-5, one GPU
    python chip_smoke.py --multi    # only the sharded four-GPU phase

Every phase goes through the entry points a user calls (``Schwarz`` ->
``solve_gevp`` -> ``build`` -> ``hpddm_tpu.solvers.krylov.solve``,
``examples/schwarz.py:main``, ``parallel.mesh.sharded_solve``) in f32 on
the card, and is compared with a plain reference that does not use the
code under test: scipy/numpy in f64, or a pinned CPU iteration count.

1. oracle: examples/schwarz.py, two-level GenEO RAS at 100^2/4;
2. grid GMV at 2048^2/16 (canvas DIA SpMM + slab exchange);
3. flagship at 1024^2/16 (contrast-1e4 channel, Jacobi-scaled, banded
   local solves, bsr coarse, Lanczos GenEO), f32 solve then iterative
   refinement to a true relative residual <= 1e-8;
4. unstructured P1 FEM at 65k vertices (ELL SpMM + general exchange):
   one GMV and a one-level GMRES solve;
5. breadth: Helmholtz ORAS vs RAS in complex64, FETI and BDD, BGMRES
   mu=4, GCRO-DR warm recycling.

``--multi`` runs the phase-3 problem sharded over four GPUs and compares
it with the batched one-GPU solve of the same state: equal iterations
(+-1), and refined solutions within 1e-5 of each other (the unrefined f32
solutions differ by their forward error, since the cards sum in another
order).

A failed phase fails the run: the script then exits 1 and prints no
result line. The last line of standard output, printed only when every
phase passed, is one JSON object naming the device. Without a GPU the
script exits 1 before doing any work. One process uses the card; the
script starts no other JAX process.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# iterations of phase 1's problem on the CPU backend in f32
# (tests/test_examples.py pins this count)
ORACLE_CPU_F32_ITS = 19
ORACLE_ARGS = ["-N", "4", "-hpddm_schwarz_coarse_correction", "deflated",
               "-hpddm_geneo_nu", "10", "-hpddm_verbosity", "1"]

_COMPILE = {"seconds": 0.0, "hits": 0, "misses": 0}


def _count_compiles():
    from jax import monitoring

    def on_duration(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            _COMPILE["seconds"] += secs

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            _COMPILE["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            _COMPILE["misses"] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    monitoring.register_event_listener(on_event)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


class Phase:
    """Collects one phase's numbers and checks; prints them as it goes."""

    def __init__(self, name):
        self.name = name
        self.ok = True

    def note(self, **kw):
        body = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"  [{self.name}] {body}", flush=True)

    def check(self, what, value, limit, ok):
        self.ok &= bool(ok)
        print(f"  [{self.name}] {'PASS' if ok else 'FAIL'} {what}: "
              f"{value} (limit {limit})", flush=True)


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _rhs(gen, sch, dtype, f_list=None):
    """Host (S, n_max, 1) right-hand side in ``dtype``."""
    f_list = gen.f if f_list is None else f_list
    f = np.zeros((len(gen.n_loc), sch.n_max, 1), dtype=dtype)
    for s in range(len(gen.n_loc)):
        f[s, : gen.n_loc[s]] = np.asarray(f_list[s]).reshape(-1, 1)
    return f


def _box_gids(boxes, Nx):
    """Global grid ids (row-major, j * Nx + i) of each box's local dofs."""
    out = []
    for (i0, i1, j0, j1) in boxes:
        jj, ii = np.meshgrid(np.arange(j0, j1), np.arange(i0, i1),
                             indexing="ij")
        out.append((jj * Nx + ii).ravel())
    return out


def _gmv_reference(mats, d, gids, x, n_global):
    """Host f64 GMV: per-subdomain scipy CSR products, a POU-weighted
    ``np.add.at`` sum over global ids, restricted back to each copy."""
    total = np.zeros((n_global, x.shape[-1]))
    for s, m in enumerate(mats):
        n = m.n
        y = m.scipy(expand=True).astype(np.float64) @ x[s, :n]
        np.add.at(total, gids[s], d[s][:n, None] * y)
    ref = np.zeros_like(x, dtype=np.float64)
    for s, m in enumerate(mats):
        ref[s, : m.n] = total[gids[s]]
    return ref


def _check_gmv(ph, state, mats, gids, n_global, dtype, reps=20):
    """One GMV against the host reference, then its steady time."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from hpddm_tpu.precond.schwarz import gmv

    S, n_max = state.dec.d.shape
    rng = np.random.default_rng(1)
    xg = rng.normal(size=(n_global, 1))
    x = np.zeros((S, n_max, 1))
    for s, g in enumerate(gids):
        x[s, : len(g)] = xg[g]
    d = np.asarray(state.dec.d, dtype=np.float64)
    y_ref = _gmv_reference(mats, d, gids, x, n_global)
    f = jax.jit(gmv)
    y = np.asarray(f(state, jnp.asarray(x.astype(dtype))), np.float64)
    err = float(np.max(np.abs(y - y_ref)))
    scale = float(np.max(np.abs(y_ref)))
    ph.check("gmv max-abs error / max|y|", f"{err / scale:.3e}", "1e-5",
             err <= 1e-5 * scale)

    @jax.jit
    def chain(st, v):
        out, _ = lax.scan(lambda c, _: (gmv(st, c), None), v, None,
                          length=reps)
        return out
    xd = jnp.asarray(x.astype(dtype))
    _timed(chain, state, xd)
    best = min(_timed(chain, state, xd)[1] for _ in range(3))
    nnz = sum(m.nnz for m in mats)
    ph.note(gmv_us=f"{best / reps * 1e6:.1f}", nnz=nnz,
            nnz_per_s=f"{nnz * reps / best:.4e}")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_oracle(ph):
    sys.path.insert(0, ROOT)
    import examples.schwarz as drv

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = drv.main(list(ORACLE_ARGS))
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    its = int(re.search(r"converges after (\d+) iteration", out).group(1))
    nr, nb = map(float, re.search(
        r"residual = ([0-9.e+-]+) / ([0-9.e+-]+)", out).groups())
    ph.note(total_s=f"{wall:.3f}", iterations=its,
            true_relres=f"{nr / nb:.3e}", peak_bytes=_peak_bytes())
    ph.check("examples/schwarz.py gates (its <= 45, relres <= 1e-2)",
             f"rc={rc}", "rc=0", rc == 0)
    ph.check("iterations vs CPU-f32 count", its,
             f"{ORACLE_CPU_F32_ITS} +- 2",
             abs(its - ORACLE_CPU_F32_ITS) <= 2)


def phase_grid_gmv(ph, S=16, N=2048):
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz

    dt = working_dtype()
    t0 = time.perf_counter()
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, dtype=dt)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, N, N)
    state = sch.operator_state()
    ph.note(setup_s=f"{time.perf_counter() - t0:.3f}",
            canvas=state.A.canvas_hw is not None,
            slab_exchange=state.dec.grid is not None)
    _check_gmv(ph, state, gen.mats, _box_gids(gen.boxes, N), N * N, dt)
    ph.note(peak_bytes=_peak_bytes())


def flagship_kappa(xx, yy):
    """Contrast-1e4 channel plus a x10 jump (tools/bench_hetero.py)."""
    return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
            * np.where(xx > 5.0, 10.0, 1.0))


def global_5pt(N, kappa):
    """The global heterogeneous 5-point finite-volume operator on [0,10]^2
    (harmonic-mean faces, Dirichlet faces take the cell's own value) and
    the three-bump right-hand side, assembled directly in scipy."""
    import scipy.sparse as sp
    from hpddm_tpu.models.diffusion2d import rhs_values

    h2 = (N / 10.0) ** 2
    jj, ii = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    c = kappa(10.0 / N * (ii + 0.5), 10.0 / N * (jj + 0.5))
    k = (jj * N + ii).ravel()
    rows, cols, vals = [k], [k], [np.zeros(N * N)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        i2, j2 = ii + di, jj + dj
        inside = (i2 >= 0) & (i2 < N) & (j2 >= 0) & (j2 < N)
        c2 = np.where(inside, c[np.clip(j2, 0, N - 1),
                                np.clip(i2, 0, N - 1)], c)
        face = np.where(inside, 2.0 * c * c2 / (c + c2), c) * h2
        vals[0] = vals[0] + face.ravel()
        m = inside.ravel()
        rows.append(k[m])
        cols.append((j2 * N + i2).ravel()[m])
        vals.append(-face.ravel()[m])
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N * N, N * N))
    b = rhs_values(ii, jj, N, N).ravel().astype(np.float64)
    return A, b


def build_flagship(ph, S=16, N=1024):
    """The flagship state, its RHS and the scaled local matrices."""
    import jax
    from hpddm_tpu.core.csr import MatrixCSR
    from hpddm_tpu.core.scaling import jacobi_scale
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz

    dt = working_dtype()
    t0 = time.perf_counter()
    # generated and scaled in f64: the refinement's host residuals use
    # the f64 matrices, the device state their f32 rounding
    gen = diffusion2d.generate_uniform(S, N, N, overlap=1,
                                       kappa=flagship_kappa,
                                       with_neumann=True, dtype=np.float64)
    mats, f_list, neu, _ = jacobi_scale(gen.mats, gen.f, gen.neumann)
    opt = Options(tol=1e-6, local_solver="banded", coarse_assembly="bsr",
                  schwarz_coarse_correction="deflated", geneo_nu=8)
    sch = Schwarz([MatrixCSR(m.scipy().astype(dt)) for m in mats],
                  gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.set_grid_geometry(gen.boxes, N, N)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sch.solve_gevp([MatrixCSR(m.scipy().astype(dt)) for m in neu],
                   method="lanczos")
    t_gevp = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = jax.block_until_ready(sch.build())
    t_build = time.perf_counter() - t0
    ph.note(generate_s=f"{t_gen:.3f}", gevp_s=f"{t_gevp:.3f}",
            build_s=f"{t_build:.3f}", n_loc=gen.n_loc[0])
    f64 = _rhs(gen, sch, np.float64, f_list)
    return gen, mats, state, f64, opt


def refine_flagship(run, mats, f64, dec, dt):
    """Host-f64 refinement of the flagship system to a weighted true
    relative residual of 1e-10; ``run(b)`` is the f32 device solve."""
    import jax.numpy as jnp
    from hpddm_tpu.solvers.refine import solve_refined

    return solve_refined(lambda b: run(jnp.asarray(b, dt)), mats, f64, dec,
                         tol=1e-10, max_refine=6)


def refine_options():
    """Inner-solve options of the refinement (tolerance 1e-3 per pass)."""
    from hpddm_tpu.options import Options
    return Options(tol=1e-3, local_solver="banded",
                   schwarz_coarse_correction="deflated", geneo_nu=8)


def phase_flagship(ph, S=16, N=1024):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    from hpddm_tpu.solvers.krylov import solve

    gen, mats, state, f64, opt = build_flagship(ph, S, N)
    dt = state.dec.d.dtype
    f = jnp.asarray(f64.astype(dt))
    solve_jit = jax.jit(lambda st, b: solve(st, b, opt=opt))
    res, t_first = _timed(solve_jit, state, f)
    res, t_solve = _timed(solve_jit, state, f)
    its = int(res.iterations)

    opt_ir = refine_options()
    ir_jit = jax.jit(lambda st, b: solve(st, b, opt=opt_ir))
    t0 = time.perf_counter()
    x, info = refine_flagship(lambda b: ir_jit(state, b), mats, f64,
                              state.dec, dt)
    t_ir = time.perf_counter() - t0

    # independent check: the global operator of the same scaled system
    A, b = global_5pt(N, flagship_kappa)
    s = 1.0 / np.sqrt(A.diagonal())
    As = sp.diags(s) @ A @ sp.diags(s)
    bs = s * b
    gids = _box_gids(gen.boxes, N)
    d = np.asarray(state.dec.d, dtype=np.float64)
    # POU-weighted average of the copies; dividing by the summed weights
    # keeps the f32-stored partition of unity from biasing it
    xg, wg = np.zeros(N * N), np.zeros(N * N)
    for k, g in enumerate(gids):
        np.add.at(xg, g, d[k, : len(g)] * x[k, : len(g), 0])
        np.add.at(wg, g, d[k, : len(g)])
    xg /= wg
    rel = float(np.linalg.norm(bs - As @ xg) / np.linalg.norm(bs))
    t0 = time.perf_counter()
    x_direct = spl.spsolve(As.tocsc(), bs)
    t_direct = time.perf_counter() - t0
    diff = float(np.linalg.norm(xg - x_direct) / np.linalg.norm(x_direct))
    ph.note(first_call_s=f"{t_first:.3f}", solve_s=f"{t_solve:.4f}",
            iterations=its, refine_s=f"{t_ir:.3f}",
            refine_passes=len(info["inner_iterations"]),
            refine_inner_its=info["inner_iterations"],
            refine_history=[f"{h:.2e}" for h in info["history"]],
            spsolve_s=f"{t_direct:.3f}", rel_diff_vs_spsolve=f"{diff:.3e}",
            peak_bytes=_peak_bytes())
    ph.check("true relres of the refined solution (global f64 operator)",
             f"{rel:.3e}", "1e-8", rel <= 1e-8)


def phase_unstructured(ph, S=16, n=256):
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.core.formats import BatchedELL
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import unstructured
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz
    from hpddm_tpu.solvers.krylov import solve

    dt = working_dtype()
    t0 = time.perf_counter()
    gen = unstructured.generate(S, n, n, overlap=2, partition="geometric",
                                seed=0, with_neumann=False, dtype=dt)
    opt = Options(tol=1e-6, max_it=1000, gmres_restart=100)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=opt)
    state = jax.block_until_ready(sch.build())
    ph.note(setup_s=f"{time.perf_counter() - t0:.3f}",
            vertices=gen.A_global.shape[0],
            ell=isinstance(state.A, BatchedELL),
            general_exchange=state.dec.grid is None
            and not state.dec.renumbered)
    _check_gmv(ph, state, gen.mats, gen.gids, gen.A_global.shape[0], dt)

    f = jnp.asarray(_rhs(gen, sch, dt))
    solve_jit = jax.jit(lambda st, b: solve(st, b, opt=opt))
    res, t_first = _timed(solve_jit, state, f)
    res, t_solve = _timed(solve_jit, state, f)
    xs = np.asarray(res.x, dtype=np.float64)
    xg = np.zeros(gen.A_global.shape[0])
    for s in range(S):
        xg[gen.gids[s]] = xs[s, : gen.n_loc[s], 0]
    fg = np.where(gen.boundary, 0.0, 1.0)
    A = gen.A_global.astype(np.float64)
    r = fg - A @ xg
    rel = float(np.linalg.norm(r) / np.linalg.norm(fg))
    # normwise backward error: the f32 rounding of even the exact solution
    # leaves a relative residual of ~1e-4 on this stiff FEM matrix, so the
    # residual is judged against |A| |x| + |f| (infinity norms)
    a_inf = float(abs(A).sum(axis=1).max())
    eta = float(np.abs(r).max()
                / (a_inf * np.abs(xg).max() + np.abs(fg).max()))
    ph.note(first_call_s=f"{t_first:.3f}", solve_s=f"{t_solve:.4f}",
            iterations=int(res.iterations), true_relres=f"{rel:.3e}",
            peak_bytes=_peak_bytes())
    # f32 solve to a preconditioned 1e-6: backward error within a few
    # hundred units of f32 roundoff
    ph.check("one-level GMRES normwise backward error (global f64 "
             "residual)", f"{eta:.3e}", "1e-5", eta <= 1e-5)


def phase_breadth(ph):
    import jax.numpy as jnp
    from hpddm_tpu.device import working_dtype
    from hpddm_tpu.models import diffusion2d, helmholtz, nonoverlap
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual
    from hpddm_tpu.precond.substructure import (Substructure, bdd_solve,
                                                feti_solve)
    from hpddm_tpu.solvers.krylov import solve

    fdt, cdt = working_dtype(), working_dtype(complex_=True)

    # Helmholtz, ORAS vs RAS, native complex
    its = {}
    for method in ("ras", "oras"):
        gen = helmholtz.generate(4, Nx=60, Ny=60, k=6.0, eps=0.0,
                                 dtype=cdt)
        opt = Options(tol=1e-6, max_it=500, gmres_restart=200,
                      schwarz_method=method)
        sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                      options=opt, optimized_mats=gen.oras_mats)
        f = jnp.asarray(_rhs(gen, sch, cdt))
        st = sch.build()
        res = solve(st, f, opt=opt)
        nb, nr = compute_residual(st, res.x, f)
        its[method] = (int(res.iterations),
                       float(np.abs(np.asarray(nr)[0] / np.asarray(nb)[0])))
    ph.note(helmholtz_its_relres=its)
    ph.check("helmholtz c64 oras its < ras its", its["oras"][0],
             f"< {its['ras'][0]}", its["oras"][0] < its["ras"][0])
    ph.check("helmholtz c64 oras true relres", f"{its['oras'][1]:.3e}",
             "1e-4", its["oras"][1] < 1e-4)

    # FETI + BDD
    gen2 = nonoverlap.generate(4, 20, 20, dtype=fdt)
    sub = Substructure(gen2.mats, gen2.neighbors, gen2.mappings,
                       options=Options())
    f2 = np.zeros((4, sub.n_max, 1), dtype=fdt)
    for s in range(4):
        f2[s, : gen2.n_loc[s], 0] = gen2.f[s]
    f2 = jnp.asarray(f2)
    for name, fn in (("feti", feti_solve), ("bdd", bdd_solve)):
        r = fn(sub.state, f2, tol=1e-5, max_it=100)
        rel = float(np.max(np.asarray(r.rel_res)))
        ph.note(**{f"{name}_its": int(r.iterations)})
        ph.check(f"{name} f32 relres, its < 60", f"{rel:.3e}",
                 "1e-4", rel < 1e-4 and int(r.iterations) < 60)

    # BGMRES mu=4, two-level
    gen3 = diffusion2d.generate(4, 80, 80, overlap=1, with_neumann=True,
                                dtype=fdt)
    opt3 = Options(tol=1e-6, max_it=300, krylov_method="bgmres",
                   deflation_tol=1e-7,
                   schwarz_coarse_correction="deflated", geneo_nu=6)
    sch3 = Schwarz(gen3.mats, gen3.neighbors, gen3.mappings, d=gen3.d,
                   options=opt3)
    sch3.solve_gevp(gen3.neumann)
    st3 = sch3.build()
    rng = np.random.default_rng(0)
    f3 = np.zeros((4, sch3.n_max, 4), dtype=fdt)
    for s in range(4):
        f3[s, : gen3.n_loc[s]] = rng.normal(size=(gen3.n_loc[s], 4))
    f3 = sch3.exchange_rhs(jnp.asarray(f3))
    res3 = solve(st3, f3, opt=opt3)
    nb3, nr3 = compute_residual(st3, res3.x, f3)
    rel3 = float(np.max(np.asarray(nr3) / np.asarray(nb3)))
    ph.note(bgmres_its=int(res3.iterations))
    ph.check("bgmres mu=4 worst true relres, its < 200", f"{rel3:.3e}",
             "1e-4", rel3 < 1e-4 and int(res3.iterations) < 200)

    # GCRO-DR: the second solve recycles the first one's space
    opt4 = Options(tol=1e-6, max_it=300, krylov_method="gcrodr",
                   recycle=10, gmres_restart=30)
    sch4 = Schwarz(gen3.mats, gen3.neighbors, gen3.mappings, d=gen3.d,
                   options=opt4)
    st4 = sch4.build()
    f4 = f3[:, :, :1]
    r1 = solve(st4, f4, opt=opt4)
    r2 = solve(st4, f4, opt=opt4)
    ph.check("gcrodr warm its <= cold its", int(r2.iterations),
             f"<= {int(r1.iterations)}",
             int(r2.iterations) <= int(r1.iterations) < 300)
    ph.note(peak_bytes=_peak_bytes())


def phase_multi(ph, S=16, N=1024, n_dev=4):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from hpddm_tpu.parallel.mesh import make_mesh, shard_state, \
        sharded_solve
    from hpddm_tpu.solvers.krylov import solve

    _, mats, state, f64, opt = build_flagship(ph, S, N)
    dt = state.dec.d.dtype
    f = jax.numpy.asarray(f64.astype(dt))
    solve_jit = jax.jit(lambda st, b: solve(st, b, opt=opt))
    ref, _ = _timed(solve_jit, state, f)
    ref, t_ref = _timed(solve_jit, state, f)

    mesh = make_mesh(n_dev)
    state_sh = shard_state(state, mesh)
    vec = NamedSharding(mesh, P("sub", None, None))
    f_sh = jax.device_put(f, vec)
    placed = {d.id: 0 for d in mesh.devices.flat}
    for leaf in jax.tree_util.tree_leaves(state_sh):
        for shard in leaf.addressable_shards:
            placed[shard.device.id] += shard.data.nbytes
    ph.note(state_bytes_per_device=placed)
    ph.check("state placed on every device of the mesh",
             sum(v > 0 for v in placed.values()), n_dev,
             all(v > 0 for v in placed.values()))
    run = jax.jit(lambda st, b: sharded_solve(st, b, opt, mesh))
    res, _ = _timed(run, state_sh, f_sh)
    res, t_sh = _timed(run, state_sh, f_sh)
    ph.note(batched_its=int(ref.iterations), batched_solve_s=f"{t_ref:.4f}",
            sharded_its=int(res.iterations), sharded_solve_s=f"{t_sh:.4f}",
            x_devices=len(res.x.sharding.device_set),
            f32_solution_rel_diff=f"{_rel_diff(res.x, ref.x):.3e}")
    ph.check("iterations sharded vs batched", int(res.iterations),
             f"{int(ref.iterations)} +- 1",
             abs(int(res.iterations) - int(ref.iterations)) <= 1)

    # the two f32 solves each stop at a preconditioned 1e-6 of a
    # contrast-1e4 system and sum in different orders, so their solutions
    # differ by the f32 forward error; the answers a user keeps are the
    # refined ones, and those must agree
    opt_ir = refine_options()
    ir_b = jax.jit(lambda st, b: solve(st, b, opt=opt_ir))
    ir_s = jax.jit(lambda st, b: sharded_solve(st, b, opt_ir, mesh))
    x_b, info_b = refine_flagship(lambda b: ir_b(state, b), mats, f64,
                                  state.dec, dt)
    x_s, info_s = refine_flagship(
        lambda b: ir_s(state_sh, jax.device_put(b, vec)), mats, f64,
        state.dec, dt)
    diff = _rel_diff(x_s, x_b)
    ph.note(refine_inner_its_batched=info_b["inner_iterations"],
            refine_inner_its_sharded=info_s["inner_iterations"],
            refined_relres_sharded=f"{info_s['history'][-1]:.3e}")
    ph.check("relative difference of the refined solutions",
             f"{diff:.3e}", "1e-5", diff <= 1e-5)


def _rel_diff(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# ----------------------------------------------------------------------

def _gpu_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def main(argv):
    import jax

    multi = "--multi" in argv
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX's first device is "
              f"{devs[0].platform!r}); nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hpddm_tpu")):
        print("chip_smoke: the hpddm_tpu package is not next to this "
              "script; nothing was run", file=sys.stderr)
        return 1
    n_need = 4 if multi else 1
    if len(devs) < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import hpddm_tpu  # noqa: F401  (sets the compile cache)

    _count_compiles()
    print(f"devices: {devs}", flush=True)
    print(f"device_kind: {devs[0].device_kind}", flush=True)
    print(f"nvidia-smi: {_gpu_info()}", flush=True)
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}",
          flush=True)

    phases = ([("multi", phase_multi)] if multi else
              [("oracle", phase_oracle), ("grid_gmv", phase_grid_gmv),
               ("flagship", phase_flagship),
               ("unstructured", phase_unstructured),
               ("breadth", phase_breadth)])
    failed = []
    for name, fn in phases:
        ph = Phase(name)
        t0, c0 = time.perf_counter(), _COMPILE["seconds"]
        print(f"== {name}", flush=True)
        try:
            fn(ph)
        except Exception:                 # noqa: BLE001 -- fails the run
            traceback.print_exc()
            ph.ok = False
        print(f"== {name}: {'PASS' if ph.ok else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f} s, of which backend "
              f"compile {_COMPILE['seconds'] - c0:.1f} s)", flush=True)
        if not ph.ok:
            failed.append(name)
    print(f"compile: backend_compile_s={_COMPILE['seconds']:.1f} "
          f"cache_hits={_COMPILE['hits']} "
          f"cache_misses={_COMPILE['misses']}", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
