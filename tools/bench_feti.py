"""FETI/BDD coarse-path benchmark: dense vs matrix-free Chebyshev.

Measures setup + solve time and iteration counts of both coarse paths at
growing subdomain counts, and reports the memory the matrix-free path
avoids (the dense BDD balancing basis W is S x nb x S*r — quadratic in
subdomain count; the dense FETI G is N_l x nc).

CPU (f64):  python tools/bench_feti.py --S 64 --N 128
GPU (f32):  python tools/bench_feti.py --S 16 --N 64 --platform gpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hpddm_tpu.timing import fetch as _fetch_sync  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--S", type=int, default=64)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--contrast", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-it", type=int, default=500)
    ap.add_argument("--platform", default="cpu", choices=("cpu", "gpu"))
    ap.add_argument("--modes", default="dense,mfree,cheby")
    ap.add_argument("--local", default="dense", choices=("dense", "banded"))
    ap.add_argument("--skip-bdd", action="store_true")
    args = ap.parse_args()

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        dtype = np.float64
    else:
        import numpy as np
        dtype = np.float32

    import jax.numpy as jnp
    from hpddm_tpu.models import nonoverlap
    from hpddm_tpu.options import Options
    from hpddm_tpu.precond.substructure import (Substructure, bdd_solve,
                                                feti_solve)

    gen = nonoverlap.generate(args.S, args.N, args.N,
                              contrast=args.contrast, dtype=dtype)
    print(f"S={args.S} grid={args.N}^2 dofs={gen.A_global.shape[0]} "
          f"local_max={max(gen.n_loc)}")

    for mode in args.modes.split(","):
        t0 = time.perf_counter()
        kw = {}
        if args.local == "banded":
            kw = dict(kernels=gen.kernels, grid_shapes=gen.grid_shapes,
                      slot_maps=gen.slot_maps)
        sub = Substructure(gen.mats, gen.neighbors, gen.mappings,
                           options=Options(substructuring_coarse=mode,
                                           substructuring_local=args.local),
                           **kw)
        st = sub.state
        t_build = time.perf_counter() - t0
        S = len(gen.mats)
        nb_max = st.bidx.shape[1]
        r_max = st.Sb_kernels.shape[2]
        ncb = S * r_max
        bytesize = np.dtype(dtype).itemsize
        w_dense_mb = S * nb_max * ncb * bytesize / 1e6
        g_dense_mb = st.N_l * st.nc * bytesize / 1e6
        extra = ""
        if mode != "dense":
            extra = f" avoided: G {g_dense_mb:.1f} MB, W {w_dense_mb:.1f} MB"
        if mode == "cheby":
            extra += (f" cheb_deg(G^TG)={st.coarse_degree}"
                      f" cheb_deg(W^TSW)={st.bdd_coarse_degree}")
        print(f"[{mode}] build {t_build:.2f}s nc={st.nc} ncb={ncb}{extra}")

        f = np.zeros((S, sub.n_max, 1), dtype=dtype)
        for s in range(S):
            f[s, : gen.n_loc[s], 0] = gen.f[s]
        f = jnp.asarray(f)

        t0 = time.perf_counter()
        res = feti_solve(st, f, tol=args.tol, max_it=args.max_it)
        _fetch_sync(res.u)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = feti_solve(st, f, tol=args.tol, max_it=args.max_it)
        _fetch_sync(res.u)
        t2 = time.perf_counter() - t0
        print(f"[{mode}] FETI  its={int(res.iterations)} "
              f"relres={float(res.rel_res.max()):.2e} "
              f"solve={t2:.2f}s (first {t1:.2f}s)")

        if not args.skip_bdd:
            t0 = time.perf_counter()
            resb = bdd_solve(st, f, tol=args.tol, max_it=args.max_it)
            _fetch_sync(resb.u)
            t1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            resb = bdd_solve(st, f, tol=args.tol, max_it=args.max_it)
            _fetch_sync(resb.u)
            t2 = time.perf_counter() - t0
            print(f"[{mode}] BDD   its={int(resb.iterations)} "
                  f"relres={float(resb.rel_res.max()):.2e} "
                  f"solve={t2:.2f}s (first {t1:.2f}s)")


if __name__ == "__main__":
    main()
