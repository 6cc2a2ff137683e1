#!/usr/bin/env python
"""Time the plain-XLA local products and exchange on the GPU.

    python tools/bench_xla_paths.py [--precision]

Measures, in one process on one GPU (f32):

* the flat DIA SpMM (no canvas annotation) and the canvas DIA SpMM of the
  2048^2/16 grid operator, mu=1;
* the ELL SpMM and the general (caller-numbering) exchange of the
  unstructured P1 FEM model at 65k and at about 1M vertices;
* one GMV chain at 2048^2/16 timed with ``jax.block_until_ready`` and
  with a scalar fetch (``hpddm_tpu.timing.fetch``), to check that the two
  barriers agree.

Each kernel runs ``L`` times inside one ``lax.scan`` (best of 5 calls);
its time is the call time over ``L``. Bytes are the least the operation
must move, counted from the array shapes; the roofline share divides the
time those bytes take at the H100's 3.35 TB/s by the measured time.

``--precision`` instead runs chip_smoke.py's phases 1 and 3 at JAX's
default matmul precision and at ``highest``, and prints both iteration
counts.
"""

import contextlib
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
L = 50


def _chain_time(step, *args):
    import jax
    from jax import lax

    @jax.jit
    def chain(v, *a):
        out, _ = lax.scan(lambda c, _: (step(c, *a), None), v, None,
                          length=L)
        return out
    jax.block_until_ready(chain(*args))
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(*args))
        best = min(best, time.perf_counter() - t0)
    return best / L


def _report(name, secs, nbytes):
    share = nbytes / HBM_BYTES_PER_S / secs
    print(f"{name:34s} {secs * 1e6:10.1f} us  {nbytes / 1e6:9.1f} MB  "
          f"{nbytes / secs / 1e9:8.1f} GB/s  roofline {share:6.1%}",
          flush=True)


def bench_dia(S=16, N=2048):
    import dataclasses
    import jax.numpy as jnp
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.ops.spmv import spmm
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz

    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, dtype=np.float32)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, N, N)
    canvas = sch.A
    flat = dataclasses.replace(canvas, canvas_hw=None, values_planes=None)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)).astype(np.float32))
    scale = 1.0 / float(np.max(np.abs(np.asarray(canvas.values)).sum(1)))
    Sd, nd, n = canvas.values.shape
    nbytes = 4 * (Sd * nd * n + 2 * Sd * n)
    for name, A in (("DIA SpMM flat 2048^2/16", flat),
                    ("DIA SpMM canvas 2048^2/16", canvas)):
        t = _chain_time(lambda c, a: spmm(a, c) * scale, x, A)
        _report(name, t, nbytes)


def bench_unstructured(nx, S=16):
    import jax.numpy as jnp
    from hpddm_tpu.models import unstructured
    from hpddm_tpu.ops.spmv import spmm
    from hpddm_tpu.parallel.ops import exchange
    from hpddm_tpu.precond.schwarz import Schwarz

    t0 = time.perf_counter()
    gen = unstructured.generate(S, nx, nx, overlap=2, with_neumann=False,
                                partition="geometric", seed=0,
                                dtype=np.float32)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d)
    A, dec = sch.A, sch.dec
    nv = gen.A_global.shape[0]
    print(f"unstructured {nx}^2: {nv} vertices, S={S}, n_max={dec.n_max}, "
          f"ELL width={A.values.shape[-1]}, m_max={dec.m_max}, "
          f"k_max={dec.k_max}, generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, dec.n_max, 1)).astype(np.float32))
    Sd, n, w = A.values.shape
    rowsum = float(np.max(np.abs(np.asarray(A.values)).sum(-1)))
    t = _chain_time(lambda c, a: spmm(a, c) * (1.0 / rowsum), x, A)
    _report(f"ELL SpMM {nv // 1000}k", t, 4 * (2 * Sd * n * w + 2 * Sd * n))
    t = _chain_time(lambda c, dc: exchange(dc, c) * (1.0 / (dc.k_max + 1)),
                    x, dec)
    m, k = dec.m_max, dec.k_max
    _report(f"general exchange {nv // 1000}k", t,
            4 * 2 * Sd * n + Sd * m * (4 + 1 + 4 * k + 2 * 4))


def bench_barrier(S=16, N=2048, length=200):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.schwarz import Schwarz, gmv
    from hpddm_tpu.timing import fetch

    gen = diffusion2d.generate_uniform(S, N, N, overlap=1, dtype=np.float32)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, N, N)
    st = sch.operator_state()
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)).astype(np.float32))

    @jax.jit
    def chain(s, v):
        out, _ = lax.scan(lambda c, _: (gmv(s, c), None), v, None,
                          length=length)
        return out
    jax.block_until_ready(chain(st, x))
    rows = []
    for _ in range(5):
        t0 = time.perf_counter()
        y = chain(st, x)
        t_enq = time.perf_counter() - t0
        jax.block_until_ready(y)
        t_bur = time.perf_counter() - t0
        fetch(y)
        t_after = time.perf_counter() - t0 - t_bur
        t0 = time.perf_counter()
        fetch(chain(st, x))
        t_fetch = time.perf_counter() - t0
        rows.append((t_enq, t_bur, t_after, t_fetch))
    for t_enq, t_bur, t_after, t_fetch in rows:
        print(f"GMV chain x{length}: enqueue {t_enq * 1e3:8.3f} ms, "
              f"block_until_ready {t_bur * 1e3:8.3f} ms, fetch after it "
              f"{t_after * 1e3:6.3f} ms, fetch alone {t_fetch * 1e3:8.3f} ms",
              flush=True)


def bench_precision():
    import jax
    import chip_smoke as cs

    for prec in (None, "highest"):
        ctx = (jax.default_matmul_precision(prec) if prec
               else contextlib.nullcontext())
        with ctx:
            for name, fn in (("oracle", cs.phase_oracle),
                             ("flagship", cs.phase_flagship)):
                ph = cs.Phase(f"{name} precision={prec or 'default'}")
                fn(ph)
                print(f"== {ph.name}: {'PASS' if ph.ok else 'FAIL'}",
                      flush=True)


def main():
    from hpddm_tpu.device import require_gpu

    dev = require_gpu()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {dev.device_kind}; nvidia-smi: {smi}", flush=True)
    if "--precision" in sys.argv:
        bench_precision()
        return
    bench_dia()
    bench_unstructured(256)
    bench_unstructured(1024)
    bench_barrier()


if __name__ == "__main__":
    main()
