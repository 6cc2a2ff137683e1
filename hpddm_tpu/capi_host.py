"""Host side of the exportable C ABI (native/capi.cpp).

Mirror of the reference's C interface (interface/HPDDM.h:66-123:
HpddmOption*, HpddmMatrixCSR*, HpddmSubdomain*, HpddmSchwarz*,
HpddmSolve): the C shim embeds CPython and forwards
every call here with raw pointers as integers; this module wraps them as
numpy views (zero-copy in, explicit copy-out) and drives the normal
hpddm_tpu API.  Handles are integer keys into a registry.

K is double on the C side; the device dtype follows the backend (f32 on
the GPU, f64 on the CPU) exactly like the in-tree models
(hpddm_tpu.device.working_dtype).
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

_registry: Dict[int, object] = {}
_ids = itertools.count(1)


def _ensure_x64():
    """The embedded interpreter starts with jax defaults; where the
    working dtype is f64 (the CPU) enable x64 so K=double survives the
    boundary (the GPU computes f32 — the in-tree model convention)."""
    import jax
    from hpddm_tpu.device import working_dtype
    if working_dtype() == np.float64:
        jax.config.update("jax_enable_x64", True)


_ensure_x64()


def _new(obj) -> int:
    h = next(_ids)
    _registry[h] = obj
    return h


def _arr(ptr: int, n: int, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    ct = {np.float64: ctypes.c_double,
          np.int32: ctypes.c_int32}[dtype]
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ct)),
                                 shape=(n,))


def _device_dtype():
    from hpddm_tpu.device import working_dtype
    return working_dtype()


# ---------------------------------------------------------------- options
def option_set(text: str) -> int:
    """Parse one or more '-hpddm_key val' pairs into the global C-ABI
    option set (HpddmOptionParseString analogue)."""
    opts = _registry.setdefault("options", {})
    toks = text.split()
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.startswith("-hpddm_"):
            key = t[len("-hpddm_"):]
            if i + 1 < len(toks) and not toks[i + 1].startswith("-hpddm_"):
                opts[key] = toks[i + 1]
                i += 2
            else:
                opts[key] = "1"
                i += 1
        else:
            i += 1
    return 0


def option_val(key: str) -> float:
    opts = _registry.setdefault("options", {})
    try:
        return float(opts.get(key, float("nan")))
    except (TypeError, ValueError):
        return float("nan")


def _build_options():
    from hpddm_tpu.options import Options
    opts = _registry.setdefault("options", {})
    kw = {}
    for k, v in opts.items():
        try:
            fv = float(v)
            kw[k] = int(fv) if fv == int(fv) and "." not in str(v) \
                and "e" not in str(v).lower() else fv
        except (TypeError, ValueError):
            kw[k] = v
    return Options(**kw)


# ----------------------------------------------------------------- matrix
def matrix_create(n: int, m: int, nnz: int, a: int, ia: int, ja: int,
                  sym: int) -> int:
    """HpddmMatrixCSRCreate: 0-based CSR (a, ia, ja), copied."""
    from hpddm_tpu.core.csr import MatrixCSR
    av = _arr(a, nnz, np.float64).copy()
    iav = _arr(ia, n + 1, np.int32).copy()
    jav = _arr(ja, nnz, np.int32).copy()
    csr = sp.csr_matrix((av, jav, iav), shape=(n, m))
    return _new(MatrixCSR(csr, sym=bool(sym)))


def matrix_destroy(h: int) -> int:
    _registry.pop(h, None)
    return 0


def csrmm(h: int, x: int, y: int, mu: int) -> int:
    """HpddmCSRMM: y = A x, column-major (n, mu) like the reference."""
    A = _registry[h]
    K = A.scipy(expand=True)
    n, m = K.shape
    xv = _arr(x, m * mu, np.float64).reshape(mu, m).T
    yv = _arr(y, n * mu, np.float64)
    yv[:] = np.asarray(K @ xv).T.ravel()
    return 0


# -------------------------------------------------------------- subdomain
def subdomain_numfact(h_mat: int) -> int:
    """HpddmSubdomainNumfact: exact local factorization (RCM banded on
    device — the analogue of the sparse direct numfact)."""
    import jax.numpy as jnp
    from hpddm_tpu.ops.banded_solve import build_banded_solver_rcm
    A = _registry[h_mat]
    dt = _device_dtype()
    solver, _ = build_banded_solver_rcm([A], A.n, dtype=jnp.dtype(dt))
    return _new((solver, A.n, dt))


def subdomain_solve(h: int, b: int, x: int, mu: int) -> int:
    import jax.numpy as jnp
    solver, n, dt = _registry[h]
    bv = _arr(b, n * mu, np.float64).reshape(mu, n).T     # (n, mu)
    xb = np.zeros((1, solver.n_max, mu), dtype=dt)
    xb[0, :n] = bv
    out = np.asarray(solver.solve(jnp.asarray(xb)))[0, :n]
    _arr(x, n * mu, np.float64)[:] = out.T.astype(np.float64).ravel()
    return 0


def subdomain_destroy(h: int) -> int:
    _registry.pop(h, None)
    return 0


# ---------------------------------------------------------------- schwarz
class _SchwarzCtx:
    def __init__(self, S: int):
        self.S = S
        self.mats: List[Optional[object]] = [None] * S
        self.neumann: List[Optional[object]] = [None] * S
        self.neighbors: List[List[int]] = [[] for _ in range(S)]
        self.mappings: List[List[np.ndarray]] = [[] for _ in range(S)]
        self.d: List[Optional[np.ndarray]] = [None] * S
        self.sch = None
        self.state = None
        self.opt = None


def schwarz_create(S: int) -> int:
    return _new(_SchwarzCtx(S))


def schwarz_set_subdomain(h: int, s: int, h_mat: int, nnbr: int,
                          nbrs: int, sizes: int, maps: int,
                          d_ptr: int) -> int:
    """Register subdomain s: its local matrix, neighbor ids, aligned
    mappings (int32, concatenated with per-neighbor sizes), optional POU."""
    ctx: _SchwarzCtx = _registry[h]
    ctx.mats[s] = _registry[h_mat]
    nb = _arr(nbrs, nnbr, np.int32)
    sz = _arr(sizes, nnbr, np.int32)
    flat = _arr(maps, int(sz.sum()), np.int32)
    ctx.neighbors[s] = [int(q) for q in nb]
    off = 0
    ctx.mappings[s] = []
    for k in range(nnbr):
        ctx.mappings[s].append(flat[off: off + sz[k]].astype(np.int64)
                               .copy())
        off += int(sz[k])
    if d_ptr:
        n = ctx.mats[s].n
        ctx.d[s] = _arr(d_ptr, n, np.float64).copy()
    return 0


def schwarz_set_neumann(h: int, s: int, h_mat: int) -> int:
    ctx: _SchwarzCtx = _registry[h]
    ctx.neumann[s] = _registry[h_mat]
    return 0


def schwarz_build(h: int) -> int:
    """CallNumfact + solveGEVP + buildCoarseOperator in one step."""
    from hpddm_tpu.precond.schwarz import Schwarz
    ctx: _SchwarzCtx = _registry[h]
    ctx.opt = _build_options()
    d = None if any(v is None for v in ctx.d) else ctx.d
    ctx.sch = Schwarz(ctx.mats, ctx.neighbors, ctx.mappings, d=d,
                      options=ctx.opt)
    if all(m is not None for m in ctx.neumann) and \
            ctx.opt.val("schwarz_coarse_correction") is not None:
        ctx.sch.solve_gevp(ctx.neumann)
    ctx.state = ctx.sch.build()
    return 0


def schwarz_solve(h: int, f_ptrs: List[int], x_ptrs: List[int],
                  mu: int) -> int:
    """HpddmSolve: per-subdomain RHS pointers in, solutions out.
    Returns the iteration count (negative on no convergence)."""
    import jax.numpy as jnp
    from hpddm_tpu.solvers.krylov import solve
    ctx: _SchwarzCtx = _registry[h]
    dt = _device_dtype()
    sch = ctx.sch
    f = np.zeros((ctx.S, sch.n_max, mu), dtype=dt)
    for s in range(ctx.S):
        n = ctx.mats[s].n
        f[s, :n] = _arr(f_ptrs[s], n * mu, np.float64).reshape(mu, n).T
    res = solve(ctx.state, jnp.asarray(f), opt=ctx.opt)
    x = np.asarray(res.x).astype(np.float64)
    for s in range(ctx.S):
        n = ctx.mats[s].n
        _arr(x_ptrs[s], n * mu, np.float64)[:] = x[s, :n].T.ravel()
    its = int(res.iterations)
    return its if bool(np.all(np.asarray(res.converged))) else -its


def schwarz_residual(h: int, x_ptrs: List[int], f_ptrs: List[int],
                     out_ptr: int, mu: int) -> int:
    """computeResidual: global ||Ax-f|| per RHS into out (length mu)."""
    import jax.numpy as jnp
    from hpddm_tpu.precond.schwarz import compute_residual
    ctx: _SchwarzCtx = _registry[h]
    dt = _device_dtype()
    sch = ctx.sch
    x = np.zeros((ctx.S, sch.n_max, mu), dtype=dt)
    f = np.zeros((ctx.S, sch.n_max, mu), dtype=dt)
    for s in range(ctx.S):
        n = ctx.mats[s].n
        x[s, :n] = _arr(x_ptrs[s], n * mu, np.float64).reshape(mu, n).T
        f[s, :n] = _arr(f_ptrs[s], n * mu, np.float64).reshape(mu, n).T
    _, nr = compute_residual(ctx.state, jnp.asarray(x), jnp.asarray(f))
    _arr(out_ptr, mu, np.float64)[:] = np.asarray(nr, dtype=np.float64)
    return 0


def schwarz_destroy(h: int) -> int:
    _registry.pop(h, None)
    return 0
