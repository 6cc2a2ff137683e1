"""Benchmark harness — prints ONE JSON line for the driver.

Headline metric: ``value`` = the 512^2 flagship's **time-to-true-1e-8**
in seconds — f32 device solve + host-f64 iterative refinement to a true
relative residual <= 1e-8, warm setup amortized separately (reported in
the unit string).

``vs_baseline`` keeps its meaning across all rounds: the reference's
iteration-count oracle (<= 45 iterations at tol 1e-6,
examples/schwarz.cpp:140) divided by our oracle-config iterations
(higher is better, 1.0 = parity with the cap).

Runs on a GPU only: without one it raises instead of measuring the CPU.
A cell that fails fails the run. Every timing bracket ends with a scalar
fetch (hpddm_tpu.timing.fetch).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _mark(msg, _t0=[None]):
    now = time.perf_counter()
    if _t0[0] is None:
        _t0[0] = now
    print(f"[bench {now - _t0[0]:6.1f}s] {msg}", file=sys.stderr, flush=True)


def main():
    import os
    # LU-free Newton-chained banded factorization for the (Jacobi-scaled)
    # flagship twin — residual-probed fallback keeps it safe everywhere
    os.environ.setdefault("HPDDM_TPU_BANDED_CHAIN", "1")
    import jax
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, compute_residual, gmv
    from hpddm_tpu.solvers.krylov import solve
    from hpddm_tpu.timing import fetch, timed

    from hpddm_tpu.device import require_gpu, working_dtype
    require_gpu()
    dtype = working_dtype()
    _mark("start")

    # --- oracle configuration: 100x100, 4 subdomains, two-level GenEO-RAS --
    S, Nx, Ny = 4, 100, 100
    gen = diffusion2d.generate(S, Nx, Ny, overlap=1, with_neumann=True,
                               dtype=dtype)
    tol = 1.0e-6 if dtype == np.float32 else 1.0e-8
    # geneo_nu=10: the reference default nu=20 enlarges the coarse space
    # with near-null modes whose f32 coarse solve noise degrades
    # right-GMRES
    opt = Options(tol=tol, schwarz_coarse_correction="deflated", geneo_nu=10)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d, options=opt)
    sch.solve_gevp(gen.neumann)
    state = sch.build()
    f = np.zeros((S, sch.n_max, 1), dtype=dtype)
    for s in range(S):
        f[s, : gen.n_loc[s]] = gen.f[s]
    f = jnp.asarray(f)

    solve_jit = jax.jit(lambda b: solve(state, b, opt=opt))
    solve_1call, _, res = timed(solve_jit, f, reps=2, warmup=1)
    its = int(res.iterations)

    # steady-state throughput: back-to-back solves; the terminal fetch
    # syncs the whole chain (same stream)
    reps = 6
    fetch(res.x)
    t0 = time.perf_counter()
    results = [solve_jit(f) for _ in range(reps)]
    fetch(results[-1].x)
    solve_time = (time.perf_counter() - t0) / reps
    _mark("oracle done")

    # --- SpMV throughput (local SpMM + halo) at flagship scale -----------
    # 2048^2/16 = 67 MB of operator values: nothing fits in cache, so the
    # number tracks the honest sustained GMV (canvas SpMM + slab halo).
    # The persistent .cache/xla keeps the compiles inside the driver
    # timeout.
    S2, Nx2, Ny2 = 16, 2048, 2048
    gen2 = diffusion2d.generate_uniform(S2, Nx2, Ny2, overlap=1, dtype=dtype)
    sch2 = Schwarz(gen2.mats, gen2.neighbors, gen2.mappings, d=gen2.d,
                   options=Options())
    sch2.set_grid_geometry(gen2.boxes, Nx2, Ny2)   # slab halo exchange
    state2 = sch2.operator_state()   # no factorization: pure GMV path
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S2, sch2.n_max, 1)).astype(dtype))

    from jax import lax

    def gmv_chain(length):
        @jax.jit
        def chain(v):
            out, _ = lax.scan(lambda c, _: (gmv(state2, c), None), v, None,
                              length=length)
            return out
        return chain

    # length-differenced timing: two scan lengths in single calls cancel
    # the fixed per-call overhead and isolate the per-step time
    L1, L2 = 10, 60
    c1, c2 = gmv_chain(L1), gmv_chain(L2)
    y = c2(c1(x))
    fetch(y)
    w1 = w2 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        y = c1(y)
        fetch(y)
        w1 = min(w1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        y = c2(y)
        fetch(y)
        w2 = min(w2, time.perf_counter() - t0)
    spmv_time = max((w2 - w1) / (L2 - L1), 1e-9)
    nnz = sum(m.nnz for m in gen2.mats)
    nnz_per_s = nnz / spmv_time

    # argument-passed GMV: the state enters the jitted chain as an
    # argument — the layout every at-scale solve actually runs
    # (closure-captured states embed as HLO literals)
    def gmv_chain_arg(length):
        @jax.jit
        def chain(st, v):
            out, _ = lax.scan(lambda c, _: (gmv(st, c), None), v, None,
                              length=length)
            return out
        return chain
    a1, a2 = gmv_chain_arg(L1), gmv_chain_arg(L2)
    y = a2(state2, a1(state2, x))
    fetch(y)
    w1 = w2 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        y = a1(state2, y)
        fetch(y)
        w1 = min(w1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        y = a2(state2, y)
        fetch(y)
        w2 = min(w2, time.perf_counter() - t0)
    gmv_arg_us = max((w2 - w1) / (L2 - L1), 1e-9) * 1e6
    _mark("spmv/gmv done")

    # --- flagship twin: heterogeneous two-level solve --------------------
    # 512^2/16 contrast-1e4 channel, Jacobi-scaled, banded exact local
    # solves, Lanczos-GenEO — a deterministic scaled-down twin of the
    # 1024^2 flagship (tools/bench_hetero.py) small enough to set up
    # inside a short budget even with cold caches.
    flagship = ""
    value = solve_time                 # replaced by time-to-1e-8 below
    from hpddm_tpu.core.scaling import jacobi_scale

    def kap(xx, yy):
        return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
                * np.where(xx > 5.0, 10.0, 1.0))

    S3, N3 = 16, 512
    gen3 = diffusion2d.generate_uniform(S3, N3, N3, overlap=1,
                                        kappa=kap, with_neumann=True,
                                        dtype=dtype)
    mats3, f3_list, neu3, _ = jacobi_scale(gen3.mats, gen3.f,
                                           gen3.neumann)
    # bsr assembly + replicated direct coarse
    opt3 = Options(tol=tol, local_solver="banded",
                   coarse_assembly="bsr",
                   schwarz_coarse_correction="deflated", geneo_nu=8)
    sch3 = Schwarz(mats3, gen3.neighbors, gen3.mappings, d=gen3.d,
                   options=opt3)
    sch3.set_grid_geometry(gen3.boxes, N3, N3)
    t0 = time.perf_counter()
    sch3.solve_gevp(neu3, method="lanczos")
    st3 = sch3.build()
    fetch(st3.dec.d)
    setup3 = time.perf_counter() - t0
    f3 = np.zeros((S3, sch3.n_max, 1), dtype=dtype)
    for s in range(S3):
        f3[s, : gen3.n_loc[s]] = f3_list[s]
    f3 = jnp.asarray(f3)
    sj3 = jax.jit(lambda st, b: solve(st, b, opt=opt3))
    t3, _, r3 = timed(sj3, st3, f3, reps=2, warmup=1)
    # true residual attained: host-f64 refinement
    # around the f32 device solve — report the *f64 true relres*,
    # not just preconditioned-tol convergence
    from hpddm_tpu.solvers.refine import solve_refined
    opt_ir = Options(tol=1e-3, local_solver="banded",
                     schwarz_coarse_correction="deflated", geneo_nu=8)
    irj = jax.jit(lambda st, b: solve(st, b, opt=opt_ir))
    t0 = time.perf_counter()
    _, info = solve_refined(lambda b: irj(st3, jnp.asarray(b)),
                            mats3, np.asarray(f3), st3.dec,
                            tol=1e-10, max_refine=6)
    t_ir = time.perf_counter() - t0
    true3 = float(info["history"][-1])
    flagship = (", flagship512=%.3fs/%dits(setup=%.0fs,"
                "true_relres=%.1e,refine=%.1fs)") % (
        t3, int(r3.iterations), setup3, true3, t_ir)
    if true3 > 1e-8:
        raise RuntimeError(f"flagship512 refined to {true3:.1e} only")
    value = t3 + t_ir

    _mark("flagship done")
    # --- S-ladder point: 2048^2 at S=256 ----------------------------------
    # banded exact local solves (device factorization + Newton chain),
    # bsr + replicated direct coarse, Lanczos-GenEO, then host-f64
    # refinement to true relres <= 1e-8 with setup / solve / refine
    # separated (reporting solve-only at tol 2e-3 would ship the f32
    # floor).
    ladder = ""
    from hpddm_tpu.core.scaling import jacobi_scale as _js
    from hpddm_tpu.solvers.refine import solve_refined as _sr

    def kap2(xx, yy):
        return (np.where((yy > 3.3) & (yy < 6.6), 1.0e4, 1.0)
                * np.where(xx > 5.0, 10.0, 1.0))

    S4, N4 = 256, 2048
    gen4 = diffusion2d.generate_uniform(S4, N4, N4, overlap=1,
                                        kappa=kap2, with_neumann=True,
                                        dtype=dtype)
    mats4, f4_list, neu4, _ = _js(gen4.mats, gen4.f, gen4.neumann)
    # level-2 cg + direct level-3 deflation of the nc=2048 coarse
    # space
    opt4 = Options(tol=2e-3, local_solver="banded",
                   coarse_assembly="bsr", gmres_restart=40,
                   schwarz_coarse_correction="deflated", geneo_nu=8,
                   level_2_krylov_method="cg", level_2_tol=1e-2,
                   level_2_max_it=50)
    sch4 = Schwarz(mats4, gen4.neighbors, gen4.mappings, d=gen4.d,
                   options=opt4)
    sch4.set_grid_geometry(gen4.boxes, N4, N4)
    t0 = time.perf_counter()
    sch4.solve_gevp(neu4, method="lanczos")
    st4 = sch4.build()
    fetch(st4.dec.d)
    setup4 = time.perf_counter() - t0
    f4 = np.zeros((S4, sch4.n_max, 1), dtype=dtype)
    for s in range(S4):
        f4[s, : gen4.n_loc[s]] = f4_list[s]
    f4 = jnp.asarray(f4)
    sj4 = jax.jit(lambda st, b: solve(st, b, opt=opt4))
    t4, _, r4 = timed(sj4, st4, f4, reps=2, warmup=1)
    irj4 = jax.jit(lambda st, b: solve(st, b, opt=opt4))
    t0 = time.perf_counter()
    _, info4 = _sr(lambda b: irj4(st4, jnp.asarray(b)),
                   mats4, np.asarray(f4), st4.dec,
                   tol=1e-10, max_refine=8)
    t_ir4 = time.perf_counter() - t0
    ladder = (", ladder256=%.2fs/%dits(setup=%.0fs,true_relres=%.1e,"
              "refine=%.1fs)") % (
        t4, int(r4.iterations), setup4,
        float(info4["history"][-1]), t_ir4)

    _mark("ladder done")
    # --- unstructured GMV ------------------------------------------------
    # jittered-Delaunay P1 FEM at 65k vertices: XLA ELL SpMM + general
    # exchange
    unstr = ""
    from hpddm_tpu.models import unstructured as _um

    genu = _um.generate(16, 256, 256, overlap=2, with_neumann=False,
                        partition="geometric", seed=0, dtype=dtype)
    schu = Schwarz(genu.mats, genu.neighbors, genu.mappings, d=genu.d,
                   options=Options())
    stu = schu.operator_state()
    nnzu = sum(m.nnz for m in genu.mats)
    xu = jnp.asarray(np.random.default_rng(2).normal(
        size=(16, schu.n_max, 1)).astype(dtype))

    def gmv_chain_u(length):
        @jax.jit
        def chain(st, v):
            out, _ = lax.scan(lambda c, _: (gmv(st, c), None), v,
                              None, length=length)
            return out
        return chain
    u1, u2 = gmv_chain_u(L1), gmv_chain_u(L2)
    y = u2(stu, u1(stu, xu))
    fetch(y)
    w1 = w2 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        y = u1(stu, y)
        fetch(y)
        w1 = min(w1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        y = u2(stu, y)
        fetch(y)
        w2 = min(w2, time.perf_counter() - t0)
    t_u = max((w2 - w1) / (L2 - L1), 1e-9)
    unstr = ", unstr_gmv_us=%.1f(%.1fGNnz/s@65k)" % (
        t_u * 1e6, nnzu / t_u / 1e9)
    _mark("unstructured done")

    print(json.dumps({
        "metric": "flagship512_time_to_true_1e-8",
        "value": round(value, 6),
        "unit": "s(solve+refine; oracle=%.4fs/%dits@tol%s, 1call=%.3fs, "
                "spmv_nnz_per_s=%.3e, gmv_arg_us=%.1f%s%s%s)"
                % (solve_time, its, tol, solve_1call, nnz_per_s, gmv_arg_us,
                   unstr, flagship, ladder),
        "vs_baseline": round(45.0 / max(its, 1), 3),
    }))


if __name__ == "__main__":
    main()
