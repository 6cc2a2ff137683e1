"""Batched block-tridiagonal LU for grid subdomains.

The reference's local solves are sparse direct factorizations (MUMPS,
PARDISO, ... — SURVEY §2.1 "MUMPS/PARDISO/PaStiX/SuiteSparse
interfaces"). The stand-ins so far are batched *dense* factors
(O(n^2) memory, caps local sizes at ~10k dofs), the constant-coefficient
DST fast solver (exact only for separable operators), and inexact
Chebyshev. This module adds the missing *exact + scalable* point for
structured subdomains: the 5-point (or any width-1-coupled) local matrix
in row-major grid ordering is block-tridiagonal with *diagonal* coupling
blocks, so block LU needs only the wy dense Schur-complement row factors

    D_1 = A_11,   D_j = A_jj - diag(cl_j) D_{j-1}^{-1} diag(cu_j)

(O(n * wx) memory instead of O(n^2)) and the solve is two lax.scan
sweeps. Non-diagonal adjacent-row coupling (Q1/H8 *elasticity* node
blocks, 9-point corner stencils) is auto-detected and handled with
dense (wx, wx) coupling blocks — same recursion with matmul couplings,
3x the coupling storage. The solve stays two lax.scan
sweeps of batched (wx, wx) x (wx, mu) matmuls — exact for
*heterogeneous* coefficients where the DST solver is only spectrally
close.

Factorization: two paths.

* ``method="device"`` (default where f32 is the working dtype, i.e. on
  the GPU): the raw blocks are extracted
  vectorized on host (one fancy-index scatter per subdomain — no scipy
  ``todense`` loops), shipped once (f32), and the Schur recursion runs
  *on device* as a ``lax.scan`` of batched inversions, each polished
  by ``newton`` steps of X <- X (2I - A X) at ``Precision.HIGHEST``.
  It avoids the host-f64 recursion and the disk round-trip of the npz
  factor cache (the device path does not touch the cache).
* ``method="host"`` (default on CPU, where x64 is available): the
  recursion runs on the host in float64 and is rounded to the device
  dtype, with the content-keyed factor cache.

``rows_per_block=r`` groups r grid rows per elimination block: the
inter-block coupling stays confined to one row of the block (the corner), so
the recursion only corrects the top-left (wx, wx) corner with the
previous factor's bottom-right corner. The sweeps shrink to wy/r steps
of (r*wx)-wide matmuls — fewer sequential latency-bound scan steps,
more work per step — at r x the factor memory.

Memory: (S, wy/r, r*wx, r*wx) inverse factors — 66k-dof subdomains
(256 x 256, r=1) at S=16 cost ~1 GB in f32 where dense inverses would
need 280 GB. Host setup is S*wy/r batched (r*wx, r*wx) inversions;
practical up to r*wx ~ 1024.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedSolver:
    """Per-subdomain block-tridiagonal LU in padded grid layout."""
    Dinv: jax.Array       # (nbk, S, L, L) inverse block factors
    cl: jax.Array         # (nbk, S, cw) lower corner coupling diag, or
    #                       (nbk, S, cw, cw) dense coupling blocks
    cu: jax.Array         # like cl (upper)
    idx_fwd: jax.Array    # (S, nbk*L) local flat row per grid slot
    msk_fwd: jax.Array    # (S, nbk*L, 1) 0/1
    idx_inv: jax.Array    # (S, n_max) grid slot per local flat row
    msk_inv: jax.Array    # (S, n_max, 1) 0/1
    wy_max: int = dataclasses.field(metadata=dict(static=True))  # = nbk
    wx_max: int = dataclasses.field(metadata=dict(static=True))  # = L
    n_max: int = dataclasses.field(metadata=dict(static=True))
    S: int = dataclasses.field(metadata=dict(static=True))
    cw: int = dataclasses.field(default=0, metadata=dict(static=True))

    def _couple(self, C, v):
        """Apply a coupling factor: diagonal (cw,) * v or dense (cw,cw) @ v."""
        if C.ndim == 3:                              # (S, cw, cw) dense
            return jnp.einsum("sij,sjm->sim", C, v)
        return C[:, :, None] * v

    def solve(self, b: jax.Array) -> jax.Array:
        """b: (S, n_max, mu) -> A^-1 b (exact block-tridiagonal solve)."""
        S, _, mu = b.shape
        L = self.wx_max
        cw = self.cw or L
        g = jnp.take_along_axis(b, self.idx_fwd[:, :, None], axis=1)
        g = (g * self.msk_fwd).reshape(S, self.wy_max, L, mu)
        g = jnp.moveaxis(g, 1, 0)                   # (nbk, S, L, mu)

        # forward: u_j = D_j^-1 (b_j - corner(cl_j * u_{j-1}[last row]))
        def fwd(u_prev, inp):
            Dinv_j, cl_j, b_j = inp
            head = b_j[:, :cw] - self._couple(cl_j, u_prev[:, L - cw:])
            z = jnp.concatenate([head, b_j[:, cw:]], axis=1) \
                if cw < L else head
            u = jnp.einsum("sij,sjm->sim", Dinv_j, z)
            return u, u

        u0 = jnp.zeros((S, L, mu), b.dtype)
        _, U = lax.scan(fwd, u0, (self.Dinv, self.cl, g))

        # backward: x_j = u_j - D_j^-1 corner'(cu_{j+1} * x_{j+1}[first row])
        cu_next = jnp.concatenate(
            [self.cu[1:], jnp.zeros((1,) + self.cu.shape[1:], self.cu.dtype)],
            axis=0)

        def bwd(x_next, inp):
            Dinv_j, cu_j1, u_j = inp
            tail = self._couple(cu_j1, x_next[:, :cw])
            t = jnp.concatenate(
                [jnp.zeros((S, L - cw, mu), u_j.dtype), tail], axis=1) \
                if cw < L else tail
            x = u_j - jnp.einsum("sij,sjm->sim", Dinv_j, t)
            return x, x

        _, X = lax.scan(bwd, u0, (self.Dinv, cu_next, U), reverse=True)

        out = jnp.moveaxis(X, 0, 1).reshape(S, self.wy_max * L, mu)
        out = jnp.take_along_axis(out, self.idx_inv[:, :, None], axis=1)
        return out * self.msk_inv


def _factor_cache_path(mats, boxes, n_max, dtype, slot_maps, r):
    """Content-keyed cache file for a banded factorization, or None.

    The host-f64 Schur recursion is the setup hot spot (~60 s per factor
    at the 1024^2 flagship: wy sequential batched (S, wx, wx) inversions
    on a 2-core host). The factors depend only on (matrices, boxes,
    slot_maps, r, dtype), so identical setups — reruns, benchmarks, GEVP
    + build sharing a matrix — load the rounded factors from disk
    instead. On by default (<repo>/.cache/factors, next to the persistent
    XLA cache); HPDDM_TPU_FACTOR_CACHE=<dir> overrides, =0 disables."""
    import hashlib
    import os
    cache_dir = os.environ.get("HPDDM_TPU_FACTOR_CACHE")
    if cache_dir == "0":
        return None
    if not cache_dir:
        cache_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".cache", "factors")
    h = hashlib.sha1()
    h.update(f"banded-v1:{n_max}:{r}:{np.dtype(dtype).name}".encode())
    for b in boxes:
        h.update(repr(tuple(int(v) for v in b)).encode())
    for s_, m in enumerate(mats):
        csr = m.scipy(expand=True).tocsr() if hasattr(m, "scipy") \
            else m.tocsr()
        h.update(np.ascontiguousarray(csr.indptr).tobytes())
        h.update(np.ascontiguousarray(csr.indices).tobytes())
        h.update(np.ascontiguousarray(csr.data).tobytes())
        if slot_maps is not None:
            h.update(np.asarray(slot_maps[s_]).tobytes())
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None                 # read-only installs: skip the cache
    return os.path.join(cache_dir, f"banded_{h.hexdigest()}.npz")


def _extract_blocks(mats, boxes, n_max, slot_maps, r, out_dtype=np.float64):
    """Vectorized raw-block extraction (host, f64 by default; the device
    factor path extracts straight into f32 — halves the host allocation
    and astype traffic of the ~2 GB flagship block tensors).

    One fancy-index scatter per subdomain replaces the old per-block
    scipy ``todense`` loops (O(nbk) scipy slices each) — the extraction
    is O(nnz) numpy.  Returns ``(D, cl, cu, idx_fwd, msk_fwd, idx_inv,
    msk_inv, dense_mode, nbk, L, wx_max)`` with D the *raw* (uninverted)
    elimination blocks, identity on padded/hole slots."""
    S = len(boxes)
    wy_hi = max(j1 - j0 for (_, _, j0, j1) in boxes)
    wx_max = max(i1 - i0 for (i0, i1, _, _) in boxes)
    nbk = -(-wy_hi // r)                 # ceil: block rows
    L = r * wx_max                       # slots per block

    entries = []
    dense_mode = False
    for s_, (i0, i1, j0, j1) in enumerate(boxes):
        wx, wy = i1 - i0, j1 - j0
        K = mats[s_].scipy(expand=True) if hasattr(mats[s_], "scipy") \
            else mats[s_].tocsr()
        coo = K.tocoo()
        slots = None if slot_maps is None else np.asarray(slot_maps[s_],
                                                          dtype=np.int64)
        if slots is not None and slots.shape[0] == wy * wx and \
                np.array_equal(slots, np.arange(wy * wx)):
            slots = None                      # identity map: no embedding
        rr = coo.row if slots is None else slots[coo.row]
        cc = coo.col if slots is None else slots[coo.col]
        data = np.asarray(coo.data, dtype=np.float64)
        if K.shape[0] < (wy * wx if slots is None else 0):
            raise ValueError(f"subdomain {s_}: matrix smaller than its box")
        rj, cj = rr // wx, cc // wx
        if np.abs(rj - cj).max(initial=0) > 1:
            raise ValueError("matrix is not block-tridiagonal in grid rows")
        # diagonal inter-row coupling (5/7-point stencils) keeps the O(cw)
        # coupling storage; anything else (elasticity node blocks, 9-point
        # corners) switches to dense (cw, cw) coupling blocks
        off = rj != cj
        if np.any(off & (rr % wx != cc % wx) & (data != 0)):
            dense_mode = True
        entries.append((rr, cc, data, wx, wy, slots))

    D = np.zeros((nbk, S, L, L), dtype=out_dtype)
    cshape = (nbk, S, wx_max, wx_max) if dense_mode else (nbk, S, wx_max)
    cl = np.zeros(cshape, dtype=out_dtype)
    cu = np.zeros(cshape, dtype=out_dtype)
    idx_fwd = np.zeros((S, nbk * L), dtype=np.int32)
    msk_fwd = np.zeros((S, nbk * L, 1))
    idx_inv = np.zeros((S, n_max), dtype=np.int32)
    msk_inv = np.zeros((S, n_max, 1))

    for s, (rr, cc, data, wx, wy, slots) in enumerate(entries):
        gy, gx = rr // wx, rr % wx
        hy, hx = cc // wx, cc % wx
        jr, jc = gy // r, hy // r
        inb = jr == jc                             # in-block entries
        pr = (gy % r) * wx_max + gx
        pc = (hy % r) * wx_max + hx
        np.add.at(D[:, s], (jr[inb], pr[inb], pc[inb]), data[inb])
        ml = jr == jc + 1      # lower coupling K[row gy0, row gy0-1] @ jr
        mu_ = jc == jr + 1     # upper coupling K[row gy0-1, row gy0] @ jc
        if dense_mode:
            np.add.at(cl[:, s], (jr[ml], gx[ml], hx[ml]), data[ml])
            np.add.at(cu[:, s], (jc[mu_], gx[mu_], hx[mu_]), data[mu_])
        else:
            kl = ml & (gx == hx)
            ku = mu_ & (gx == hx)
            np.add.at(cl[:, s], (jr[kl], gx[kl]), data[kl])
            np.add.at(cu[:, s], (jc[ku], gx[ku]), data[ku])
        # identity diagonal on inactive slots (box padding + holes)
        n = wy * wx
        eff = np.arange(n) if slots is None else slots
        canvas = (eff // wx) * wx_max + (eff % wx)   # block-slot flat index
        active = np.zeros(nbk * L, dtype=bool)
        active[canvas] = True
        inact = np.nonzero(~active)[0]
        D[inact // L, s, inact % L, inact % L] = 1.0
        idx_fwd[s, canvas] = np.arange(len(eff))
        msk_fwd[s, canvas, 0] = 1.0
        idx_inv[s, : len(eff)] = canvas
        msk_inv[s, : len(eff), 0] = 1.0
    return (D, cl, cu, idx_fwd, msk_fwd, idx_inv, msk_inv, dense_mode,
            nbk, L, wx_max)


def _schur_host(D, cl, cu, dense_mode, wx_max):
    """Host-f64 Schur recursion, in place: D <- per-block inverse factors.

    Inversions *batched over subdomains* (threaded LAPACK: ~4x faster
    than per-subdomain loops); cl/cu are zero beyond each subdomain's
    true wx, so the batched corner correction is a no-op on padded
    slots."""
    L = D.shape[-1]
    lo = L - wx_max
    prev = np.linalg.inv(D[0])
    D[0] = prev
    for jb in range(1, D.shape[0]):
        corner = prev[:, lo:, lo:]
        if dense_mode:
            D[jb, :, :wx_max, :wx_max] -= cl[jb] @ corner @ cu[jb]
        else:
            D[jb, :, :wx_max, :wx_max] -= \
                cl[jb][:, :, None] * corner * cu[jb][:, None, :]
        prev = np.linalg.inv(D[jb])
        D[jb] = prev
    return D


@functools.partial(jax.jit,
                   static_argnames=("dense_mode", "newton", "wx_max"))
def _schur_device_chain(D, cl, cu, *, dense_mode, newton, wx_max):
    """Newton-chained device recursion: LU-free except for block 0.

    Consecutive Schur blocks differ by a contraction (D_{j+1} - D_j =
    -cl (X_j - X_{j-1}) cu for interior rows), so the previous block's
    inverse is a convergent Newton seed for the next one: X <- X (2I - A X)
    quadratically at ~2 batched matmuls per step — no LU / triangular
    solves anywhere in the scan (batched LU is latency-bound at these
    sizes; matmuls are not). Block 0 takes one real
    batched inverse outside the scan. ``newton`` here is the chained step
    count (needs ~6: the first blocks start ~0.3 away in residual norm).
    """
    L = D.shape[-1]
    lo = L - wx_max
    hp = jax.lax.Precision.HIGHEST
    eye = jnp.eye(L, dtype=D.dtype)

    def polish(X, A, steps):
        for _ in range(steps):
            R = eye - jnp.einsum("sij,sjk->sik", A, X, precision=hp)
            X = X + jnp.einsum("sij,sjk->sik", X, R, precision=hp)
        return X

    def step(carry, inp):
        prev, dprev = carry
        Dj, clj, cuj = inp
        corner = prev[:, lo:, lo:]
        if dense_mode:
            corr = jnp.einsum("sij,sjk->sik", clj,
                              jnp.einsum("sij,sjk->sik", corner, cuj,
                                         precision=hp), precision=hp)
        else:
            corr = clj[:, :, None] * corner * cuj[:, None, :]
        A = Dj.at[:, :wx_max, :wx_max].add(-corr)
        # seed = previous inverse, column-scaled by the diagonal ratio:
        # absorbs row-scaling jumps between consecutive blocks (coefficient
        # channels aligned with grid rows would otherwise put the seed
        # outside Newton's convergence ball)
        dnew = jnp.diagonal(A, axis1=1, axis2=2)             # (S, L)
        ratio = dprev / jnp.where(jnp.abs(dnew) > 0, dnew, 1.0)
        X = polish(prev * ratio[:, None, :], A, newton)
        return (X, dnew), X

    with jax.default_matmul_precision("float32"):
        X0 = polish(jnp.linalg.inv(D[0]), D[0], 1)
        d0 = jnp.diagonal(D[0], axis1=1, axis2=2)
        _, Dinv = lax.scan(step, (X0, d0), (D[1:], cl[1:], cu[1:]))
    return jnp.concatenate([X0[None], Dinv], axis=0)


@functools.partial(jax.jit, static_argnames=("dense_mode", "wx_max"))
def _chain_residual(Dinv, D, cl, cu, *, dense_mode, wx_max):
    """max_j ||I - A_j X_j||_inf over the stored chain factors.

    Validates the Newton-chained recursion (ADVICE r4: divergence can
    leave *finite* but badly inaccurate factors that pass an isfinite
    guard and silently degrade the preconditioner).  Recomputes each
    Schur block A_j = D_j - cl_j X_{j-1}[lo:, lo:] cu_j from the stored
    inverses — the recursion's own definition — in a memory-bounded scan
    (one block resident at a time)."""
    L = D.shape[-1]
    lo = L - wx_max
    hp = jax.lax.Precision.HIGHEST
    eye = jnp.eye(L, dtype=D.dtype)

    def step(carry, inp):
        prev, err = carry
        Dj, clj, cuj, Xj = inp
        corner = prev[:, lo:, lo:]
        if dense_mode:
            corr = jnp.einsum("sij,sjk->sik", clj,
                              jnp.einsum("sij,sjk->sik", corner, cuj,
                                         precision=hp), precision=hp)
        else:
            corr = clj[:, :, None] * corner * cuj[:, None, :]
        A = Dj.at[:, :wx_max, :wx_max].add(-corr)
        R = eye - jnp.einsum("sij,sjk->sik", A, Xj, precision=hp)
        err = jnp.maximum(err, jnp.abs(R).sum(-1).max())
        return (Xj, err), None

    with jax.default_matmul_precision("float32"):
        R0 = eye - jnp.einsum("sij,sjk->sik", D[0], Dinv[0], precision=hp)
        err0 = jnp.abs(R0).sum(-1).max()
        (_, err), _ = lax.scan(step, (Dinv[0], err0),
                               (D[1:], cl[1:], cu[1:], Dinv[1:]))
    return err


@functools.partial(jax.jit,
                   static_argnames=("dense_mode", "newton", "wx_max"))
def _schur_device(D, cl, cu, *, dense_mode, newton, wx_max):
    """On-device Schur recursion: lax.scan of batched inversions.

    Working precision is the device dtype (f32 on the GPU).  The whole
    recursion is traced under ``default_matmul_precision("float32")`` —
    without it, ``jnp.linalg.inv``'s *internal* triangular solves/matmuls
    may run at a reduced default precision (TF32 on the GPU) and degrade
    the factors.  Each
    LU inverse is additionally polished with ``newton`` steps of
    X <- X + X (I - A X); the LDU telescoping is self-consistent (the
    product of the stored factors reconstructs the original blocks for
    *any* stored corner), so per-step errors do not compound — validated
    against host-f64 factors in tests/test_banded.py (local solve
    residual 2.1e-6 device vs 1.6e-6 host at contrast 1e4).
    """
    L = D.shape[-1]
    lo = L - wx_max
    hp = jax.lax.Precision.HIGHEST
    eye = jnp.eye(L, dtype=D.dtype)

    def polish(X, A):
        for _ in range(newton):
            R = eye - jnp.einsum("sij,sjk->sik", A, X, precision=hp)
            X = X + jnp.einsum("sij,sjk->sik", X, R, precision=hp)
        return X

    def step(prev, inp):
        Dj, clj, cuj = inp
        corner = prev[:, lo:, lo:]
        if dense_mode:
            corr = jnp.einsum("sij,sjk->sik", clj,
                              jnp.einsum("sij,sjk->sik", corner, cuj,
                                         precision=hp), precision=hp)
        else:
            corr = clj[:, :, None] * corner * cuj[:, None, :]
        A = Dj.at[:, :wx_max, :wx_max].add(-corr)
        X = polish(jnp.linalg.inv(A), A)
        return X, X

    with jax.default_matmul_precision("float32"):
        # cl[0] is all-zero: the first step's corner correction vanishes
        _, Dinv = lax.scan(step, jnp.zeros_like(D[0]), (D, cl, cu))
    return Dinv


def build_banded_solver(mats: Sequence, boxes: Sequence[Tuple[int, int, int, int]],
                        n_max: int, dtype=jnp.float32,
                        slot_maps: Optional[Sequence] = None,
                        rows_per_block: int = 1,
                        method: str = "auto") -> BandedSolver:
    """Factor local matrices given in row-major grid ordering.

    mats: MatrixCSR (or scipy) local matrices, local index = iy*wx + ix;
    boxes: (i0, i1, j0, j1) per subdomain. Raises if a matrix couples
    grid rows more than one apart (not block-tridiagonal).

    slot_maps (optional): per-subdomain int array mapping local row ->
    grid slot iy*wx + ix, for node sets that do not fill their bounding
    box (e.g. a missing corner): the matrix is embedded into the full box
    with identity rows on the holes — still block-tridiagonal.

    rows_per_block: grid rows eliminated per block (see module doc).

    method: "device" runs the Schur recursion on the accelerator (module
    doc; no disk cache — recomputing beats loading), "host" in f64 on the
    host with the content-keyed factor cache, "auto" (default) picks
    device when ``dtype`` is the device's f32 working dtype (GPU runs)
    and host otherwise (f64 CPU runs).  HPDDM_TPU_BANDED_FACTOR overrides;
    HPDDM_TPU_BANDED_NEWTON sets the device-path polish steps (default 1).
    """
    import os
    S = len(boxes)
    r = max(int(rows_per_block), 1)
    method = os.environ.get("HPDDM_TPU_BANDED_FACTOR", method)
    if method not in ("auto", "host", "device"):
        raise ValueError(f"unknown banded factor method {method!r}")
    if method == "auto":
        from hpddm_tpu.device import working_dtype
        method = "device" if (np.dtype(dtype) == np.float32
                              and working_dtype() == np.float32) else "host"

    if method == "device":
        npdt = np.dtype(dtype)
        real_dt = np.float64 if npdt.itemsize >= 8 else npdt
        (D, cl, cu, idx_fwd, msk_fwd, idx_inv, msk_inv, dense_mode,
         nbk, L, wx_max) = _extract_blocks(mats, boxes, n_max, slot_maps, r,
                                           out_dtype=real_dt)
        Dd = jnp.asarray(D.astype(npdt, copy=False))
        cld = jnp.asarray(cl.astype(npdt, copy=False))
        cud = jnp.asarray(cu.astype(npdt, copy=False))
        Dinv = None
        if os.environ.get("HPDDM_TPU_BANDED_CHAIN", "0") == "1":
            newton = int(os.environ.get("HPDDM_TPU_BANDED_NEWTON", "6"))
            Dinv = _schur_device_chain(Dd, cld, cud, dense_mode=dense_mode,
                                       newton=newton, wx_max=wx_max)
            # residual probe (ADVICE r4): Newton divergence can leave
            # finite-but-inaccurate factors; validate max_j ||I - A_j X_j||
            # against a threshold and fall back to the LU recursion.
            # One extra pass over the factors (~1 Newton step of cost).
            err = float(_chain_residual(Dinv, Dd, cld, cud,
                                        dense_mode=dense_mode,
                                        wx_max=wx_max))
            chain_tol = float(os.environ.get("HPDDM_TPU_BANDED_CHAIN_TOL",
                                             "1e-2"))
            if not np.isfinite(err) or err > chain_tol:
                Dinv = None
        if Dinv is None:
            newton = int(os.environ.get("HPDDM_TPU_BANDED_NEWTON", "1"))
            Dinv = _schur_device(Dd, cld, cud, dense_mode=dense_mode,
                                 newton=newton, wx_max=wx_max)
        return BandedSolver(
            Dinv=Dinv,
            cl=jnp.asarray(cl.astype(npdt, copy=False)),
            cu=jnp.asarray(cu.astype(npdt, copy=False)),
            idx_fwd=jnp.asarray(idx_fwd),
            msk_fwd=jnp.asarray(msk_fwd.astype(npdt, copy=False)),
            idx_inv=jnp.asarray(idx_inv),
            msk_inv=jnp.asarray(msk_inv.astype(npdt, copy=False)),
            wy_max=nbk, wx_max=L, n_max=n_max, S=S, cw=wx_max)

    cache_path = _factor_cache_path(mats, boxes, n_max, dtype, slot_maps, r)
    if cache_path is not None and os.path.exists(cache_path):
        z = np.load(cache_path)
        return BandedSolver(
            Dinv=jnp.asarray(z["Dinv"]), cl=jnp.asarray(z["cl"]),
            cu=jnp.asarray(z["cu"]),
            idx_fwd=jnp.asarray(z["idx_fwd"]),
            msk_fwd=jnp.asarray(z["msk_fwd"]),
            idx_inv=jnp.asarray(z["idx_inv"]),
            msk_inv=jnp.asarray(z["msk_inv"]),
            wy_max=int(z["wy_max"]), wx_max=int(z["wx_max"]),
            n_max=int(z["n_max"]), S=int(z["S"]), cw=int(z["cw"]))

    (Dinv, cl, cu, idx_fwd, msk_fwd, idx_inv, msk_inv, dense_mode,
     nbk, L, wx_max) = _extract_blocks(mats, boxes, n_max, slot_maps, r)
    Dinv = _schur_host(Dinv, cl, cu, dense_mode, wx_max)

    # convert with numpy first: jnp.asarray's dtype-converting path is
    # an order of magnitude slower than astype + same-dtype ingestion
    # (measured 24 s vs ~2 s on the 2.2 GB flagship factor)
    npdt = np.dtype(dtype)
    Dinv_d = Dinv.astype(npdt, copy=False)
    cl_d = cl.astype(npdt, copy=False)
    cu_d = cu.astype(npdt, copy=False)
    msk_fwd_d = msk_fwd.astype(npdt, copy=False)
    msk_inv_d = msk_inv.astype(npdt, copy=False)
    if cache_path is not None:
        # store the *rounded* factors: reloads are bit-identical to this
        # build and half the size of the host-f64 intermediates.
        # Write-then-rename so a concurrent process never reads a
        # partially written npz (the suite runs drivers in subprocesses).
        tmp_path = f"{cache_path}.tmp{os.getpid()}"
        try:
            np.savez(tmp_path, Dinv=Dinv_d, cl=cl_d, cu=cu_d,
                     idx_fwd=idx_fwd, msk_fwd=msk_fwd_d, idx_inv=idx_inv,
                     msk_inv=msk_inv_d, wy_max=nbk, wx_max=L, n_max=n_max,
                     S=S, cw=wx_max)
            os.replace(f"{tmp_path}.npz", cache_path)
        except OSError:
            try:                      # don't leak the tmp file on failure
                os.unlink(f"{tmp_path}.npz")
            except OSError:
                pass
    return BandedSolver(
        Dinv=jnp.asarray(Dinv_d),
        cl=jnp.asarray(cl_d),
        cu=jnp.asarray(cu_d),
        idx_fwd=jnp.asarray(idx_fwd),
        msk_fwd=jnp.asarray(msk_fwd_d),
        idx_inv=jnp.asarray(idx_inv),
        msk_inv=jnp.asarray(msk_inv_d),
        wy_max=nbk, wx_max=L, n_max=n_max, S=S, cw=wx_max)


def build_banded_solver_rcm(mats: Sequence, n_max: int, dtype=jnp.float32,
                            rows_per_block: int = 1, method: str = "auto",
                            wx: Optional[int] = None):
    """Banded exact local solves for *unstructured* matrices (round 5).

    The grid path above needs a row-major grid numbering; an arbitrary FEM
    matrix has none.  Reverse Cuthill-McKee gives each local matrix a
    numbering with bandwidth b ~ O(sqrt(n)); any banded matrix with
    bandwidth <= wx is block-tridiagonal in blocks of wx rows (couplings
    reach at most the adjacent block), so the same batched Schur recursion
    applies — with dense (wx, wx) coupling blocks, auto-detected by
    ``_extract_blocks``.  The RCM permutation itself rides the solver's
    existing slot gathers (``idx_fwd``/``idx_inv``), so ``solve`` takes and
    returns vectors in the caller's local numbering at no extra cost.

    This is the stand-in for the reference's sparse direct local
    factorizations on unstructured subdomains (SURVEY §2.1 MUMPS/PARDISO
    rows; fill-reducing ordering there, band-reducing ordering here —
    band solves are scan+matmul-shaped, nested-dissection solves are
    not).

    wx: optional bandwidth override (>= max RCM bandwidth; rounded up to 8).
    Returns (solver, bandwidths) — bandwidths per subdomain, for logging.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csrs, slot_maps, boxes, bws = [], [], [], []
    for m in mats:
        K = m.scipy(expand=True) if hasattr(m, "scipy") else m.tocsr()
        perm = np.asarray(reverse_cuthill_mckee(K, symmetric_mode=True))
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        coo = K.tocoo()
        b = int(np.abs(iperm[coo.row].astype(np.int64)
                       - iperm[coo.col]).max(initial=1))
        bws.append(b)
        csrs.append(K)
        slot_maps.append(iperm.astype(np.int64))
    wx_eff = int(-(-max(max(bws), 8) // 8) * 8) if wx is None else int(wx)
    if wx_eff < max(bws):
        raise ValueError(f"wx={wx_eff} below max RCM bandwidth {max(bws)}")
    for K in csrs:
        n = K.shape[0]
        boxes.append((0, wx_eff, 0, -(-n // wx_eff)))
    solver = build_banded_solver(csrs, boxes, n_max, dtype=dtype,
                                 slot_maps=slot_maps,
                                 rows_per_block=rows_per_block,
                                 method=method)
    return solver, bws
