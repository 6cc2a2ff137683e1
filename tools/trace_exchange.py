#!/usr/bin/env python
"""Capture an XLA op-level profile of the grid exchange (and GMV) on the
current backend, then print the top ops by self time from the trace."""

import glob
import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.options import Options
    from hpddm_tpu.parallel.ops import scaled_exchange
    from hpddm_tpu.precond.schwarz import Schwarz, gmv

    argv = [int(a) for a in sys.argv[1:4]] or [16, 2048, 2048]
    S, Nx, Ny = argv
    dtype = np.float32
    gen = diffusion2d.generate_uniform(S, Nx, Ny, overlap=1, dtype=dtype)
    sch = Schwarz(gen.mats, gen.neighbors, gen.mappings, d=gen.d,
                  options=Options())
    sch.set_grid_geometry(gen.boxes, Nx, Ny)
    state = sch.operator_state()
    dec = state.dec
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(S, sch.n_max, 1)).astype(dtype))

    @jax.jit
    def chain(v):
        out, _ = lax.scan(lambda c, _: (scaled_exchange(dec, c), None), v,
                          None, length=20)
        return out

    y = chain(x)
    _fetch_sync(y)

    logdir = "/tmp/jax-trace-exchange"
    os.system(f"rm -rf {logdir}")
    with jax.profiler.trace(logdir):
        y = chain(y)
        _fetch_sync(y)

    # find the trace events file
    paths = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
    if not paths:
        print("no trace produced; files:",
              glob.glob(f"{logdir}/**/*", recursive=True))
        return
    with gzip.open(paths[0], "rt") as fh:
        trace = json.load(fh)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    # keep device-side events (TensorFlow Op / XLA Op rows)
    agg = {}
    for e in events:
        name = e.get("name", "?")
        agg.setdefault(name, [0, 0.0])
        agg[name][0] += 1
        agg[name][1] += e["dur"]
    top = sorted(agg.items(), key=lambda kv: -kv[1][1])[:40]
    for name, (cnt, dur) in top:
        print(f"{dur/20:10.1f} us/step x{cnt:5d}  {name[:110]}")


if __name__ == "__main__":
    main()
