"""True block Krylov methods: BGMRES, BCG, BFBCG.

Re-design of include/HPDDM_GMRES.hpp:159-313 (BGMRES) and
include/HPDDM_CG.hpp:170-484 (BCG / BFBCG):

* all small (mu x mu) algebra is batched dense,
* rank deficiency is handled with eigh-based pseudo-inverses / column
  masking instead of RRQR column pivoting (fixed shapes for XLA): a
  direction whose Gram eigenvalue falls below ``deflation_tol`` stops
  contributing, which is the breakdown-free mechanism of BFBCG
  (Ji & Li) and the ``deflation_tol`` RHS-dropping of the reference,
* POU-weighted block dots ride the same single psum as the CGS Gram.

The block Hessenberg least-squares in BGMRES is solved per restart with a
dense QR of the (k+1)mu x k*mu rotated matrix (small), not Givens — simpler
and matmul-shaped at these sizes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from hpddm_tpu.dtypes import HPDDM_EPS, underlying
from hpddm_tpu.solvers.base import LinearOperator
from hpddm_tpu.solvers.gmres import KrylovResult


def _block_dot(op: LinearOperator, X: jax.Array, Y: jax.Array) -> jax.Array:
    """<X, Y> block Gram (mu x mu) with POU weighting + psum."""
    if op.weight is not None:
        Yw = op.weight[:, :, None] * Y
    else:
        Yw = Y
    local = jnp.einsum("sna,snb->ab", jnp.conj(X), Yw)
    from hpddm_tpu.parallel.ops import psum_if
    return psum_if(local, op.axis_name)


def _psd_pinv(G: jax.Array, rtol: float) -> jax.Array:
    """Pseudo-inverse of a small PSD Gram matrix, truncating below rtol."""
    w, v = jnp.linalg.eigh(G)
    wmax = jnp.max(jnp.abs(w))
    keep = w > jnp.maximum(rtol * wmax, 0.0)
    inv_w = jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0)
    return (v * inv_w[None, :]) @ jnp.conj(v).T



def _init_norm(op: LinearOperator, b: jax.Array, rdtype):
    """Per-RHS convergence reference norms, penalty-filtered
    (initializeNorm, HPDDM_iterative.hpp:455-470)."""
    fb = op.norm_filter(b) if op.norm_filter is not None else b
    return jnp.sqrt(jnp.abs(jnp.diagonal(_block_dot(op, fb, fb))))\
        .astype(rdtype)


def _chol_qr(op: LinearOperator, V: jax.Array, rtol: float = 1e-14):
    """Distributed CholQR of a block V (S, n, mu): V = Q R
    (HPDDM_iterative.hpp:559-582). Returns (Q, R). Rank-deficient columns
    are neutralized through the pseudo-inverse."""
    G = _block_dot(op, V, V)
    mu = G.shape[0]
    # Cholesky when well-conditioned; fall back to eigh square root
    w, U = jnp.linalg.eigh(G)
    wmax = jnp.max(jnp.abs(w))
    keep = w > jnp.maximum(rtol * wmax, 0.0)
    sqrt_w = jnp.sqrt(jnp.where(keep, w, 1.0))
    R = (U * jnp.where(keep, sqrt_w, 0.0)[None, :]) @ jnp.conj(U).T
    R_inv = (U * jnp.where(keep, 1.0 / sqrt_w, 0.0)[None, :]) @ jnp.conj(U).T
    Q = jnp.einsum("sna,ab->snb", V, R_inv)
    return Q, R


def _gs_qr(op: LinearOperator, V: jax.Array, kind: str = "cgs",
           rtol: float = 1e-14):
    """Column Gram-Schmidt QR of a block V (S, n, mu): the ``-hpddm_qr
    cgs|mgs`` distributed QR paths (HPDDM_iterative.hpp:622-666). cgs does
    one fused Gram (+ psum) per column; mgs one dot (+ psum) per previous
    column. mu is a static shape, so the column loop unrolls at trace time.
    Near-dependent columns (norm below sqrt(rtol) of their pre-
    orthogonalization size) are zeroed like the CholQR pseudo-inverse."""
    S, n, mu = V.shape
    dtype = V.dtype
    R = jnp.zeros((mu, mu), dtype=dtype)
    Q = jnp.zeros_like(V)
    floor_rel = jnp.sqrt(jnp.asarray(max(rtol, 1e-30),
                                     jnp.zeros(0, dtype).real.dtype))
    for j in range(mu):
        v = V[:, :, j: j + 1]
        nrm0 = jnp.sqrt(jnp.abs(op.norm_sq(v)))[0]
        if kind == "cgs":
            # columns >= j of Q are still zero, so the full Gram is
            # automatically masked to the previous columns
            r = _block_dot(op, Q, v)[:, 0]                   # (mu,)
            v = v - jnp.einsum("snk,k->sn", Q, r)[:, :, None]
            R = R.at[:, j].add(r)
        else:                                                # mgs
            for k in range(j):
                r_kj = op.dot(Q[:, :, k: k + 1], v)[0]
                v = v - r_kj * Q[:, :, k: k + 1]
                R = R.at[k, j].set(r_kj.astype(dtype))
        nrm = jnp.sqrt(jnp.abs(op.norm_sq(v)))[0]
        ok = nrm > floor_rel * jnp.maximum(nrm0, 1e-30)
        safe = jnp.where(ok, nrm, 1.0)
        Q = Q.at[:, :, j].set(jnp.where(ok, (v / safe)[:, :, 0], 0))
        R = R.at[j, j].set(jnp.where(ok, nrm, 0.0).astype(dtype))
    return Q, R


def _qr(op: LinearOperator, V: jax.Array, kind: str = "cholqr",
        rtol: float = 1e-14):
    """Distributed QR dispatch on ``-hpddm_qr`` (cholqr | cgs | mgs)."""
    if kind in ("cgs", "mgs"):
        return _gs_qr(op, V, kind, rtol)
    return _chol_qr(op, V, rtol)


def bgmres(op: LinearOperator, b: jax.Array, x0: Optional[jax.Array] = None,
           tol: float = 1.0e-6, restart: int = 40, max_it: int = 100,
           variant: str = "right", ortho: str = "cgs",
           deflation_tol: float = -1.0, qr: str = "cholqr") -> KrylovResult:
    """Block GMRES: one Krylov space for all mu RHS simultaneously."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    S, n, mu = b.shape
    m = int(restart)
    dtype = b.dtype
    rdtype = underlying(dtype)
    left = variant == "left"
    flexible = variant == "flexible"

    nb = op.apply(b) if left else b
    norm = _init_norm(op, nb, rdtype)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    class Carry(NamedTuple):
        x: jax.Array
        it: jax.Array
        first_it: jax.Array
        res: jax.Array
        stop: jax.Array
        hist: jax.Array

    def cycle(carry: Carry) -> Carry:
        x = carry.x
        r = b - op.gmv(x)
        if left:
            r = op.apply(r)
        Q0, R0 = _qr(op, r, qr)
        V = jnp.zeros((m + 1, S, n, mu), dtype=dtype).at[0].set(Q0)
        Z = jnp.zeros((m, S, n, mu), dtype=dtype) if flexible else None
        # block Hessenberg: H[j, i] is the (mu x mu) block in block-row j,
        # block-col i
        H = jnp.zeros((m + 1, m, mu, mu), dtype=dtype)

        class Inner(NamedTuple):
            V: jax.Array
            Z: Optional[jax.Array]
            H: jax.Array
            i: jax.Array
            it: jax.Array
            first_it: jax.Array
            res: jax.Array
            all_conv: jax.Array
            hist: jax.Array

        def residuals(Hc, i):
            """Per-RHS residuals of the block LS via dense lstsq on the
            (m+1)mu x m*mu matrix with masked columns; also the update Y."""
            Hmat = Hc.transpose(0, 2, 1, 3).reshape((m + 1) * mu, m * mu)
            col_active = (jnp.arange(m)[:, None] < i)
            cmask = jnp.broadcast_to(col_active, (m, mu)).reshape(-1)
            Hmat = jnp.where(cmask[None, :], Hmat, 0)
            # rhs: E1 R0 — block residual in the Krylov basis
            rhs = jnp.zeros(((m + 1) * mu, mu), dtype=dtype).at[:mu].set(R0)
            # regularized normal equations on the small system (sizes
            # (m*mu)^2 ~ 160^2: cheap, matmul-shaped)
            G = jnp.conj(Hmat).T @ Hmat
            G = G + 10 * jnp.finfo(rdtype).eps * jnp.trace(G).real \
                * jnp.eye(m * mu, dtype=dtype) / (m * mu)
            Y = _psd_pinv(G, 1e-14) @ (jnp.conj(Hmat).T @ rhs)
            Y = jnp.where(cmask[:, None], Y, 0)
            res_block = rhs - Hmat @ Y
            res = jnp.linalg.norm(res_block, axis=0).astype(rdtype)
            return Y, res

        def inner_cond(st: Inner):
            return (st.i < m) & (st.it <= max_it) & ~st.all_conv

        def inner_body(st: Inner) -> Inner:
            vi = st.V[st.i]
            if left:
                w = op.apply(op.gmv(vi))
                Z_new = st.Z
            else:
                z = op.apply(vi)
                w = op.gmv(z)
                Z_new = st.Z.at[st.i].set(z) if flexible else st.Z

            # block orthogonalization (CGS: one fused Gram + update)
            mask = (jnp.arange(m + 1) <= st.i)[:, None, None]
            if op.weight is not None:
                ww = op.weight[:, :, None] * w
            else:
                ww = w
            Hcol = jnp.einsum("ksna,snb->kab", jnp.conj(st.V), ww)
            from hpddm_tpu.parallel.ops import psum_if
            Hcol = psum_if(Hcol, op.axis_name)
            Hcol = jnp.where(mask, Hcol, 0)
            w = w - jnp.einsum("kab,ksna->snb", Hcol, st.V)
            Qn, Rn = _qr(op, w, qr)
            H_new = st.H.at[:, st.i].set(Hcol).at[st.i + 1, st.i].set(Rn)
            V_new = st.V.at[st.i + 1].set(Qn)

            Y, res = residuals(H_new, st.i + 1)
            crossed = res <= tol * norm
            first_new = jnp.where((st.first_it == 0) & crossed, st.it,
                                  st.first_it)
            hist = st.hist.at[jnp.minimum(st.it, max_it)].set(
                (res / norm).astype(st.hist.dtype))
            return Inner(V_new, Z_new, H_new, st.i + 1, st.it + 1, first_new,
                         res, jnp.all(crossed), hist)

        st0 = Inner(V, Z, H, jnp.int32(0), carry.it, carry.first_it,
                    carry.res, jnp.array(False), carry.hist)
        stf = lax.while_loop(inner_cond, inner_body, st0)

        Y, _ = residuals(stf.H, stf.i)
        Yb = Y.reshape(m, mu, mu)
        if flexible:
            upd = jnp.einsum("kab,ksna->snb", Yb, stf.Z)
        else:
            u = jnp.einsum("kab,ksna->snb", Yb, stf.V[:m])
            upd = op.apply(u) if not left else u
        x_new = x + upd
        stop = stf.all_conv | (stf.it > max_it)
        return Carry(x_new, stf.it, stf.first_it, stf.res, stop, stf.hist)

    carry0 = Carry(x0, jnp.int32(1), jnp.zeros((mu,), jnp.int32),
                   jnp.full((mu,), jnp.inf, dtype=rdtype), jnp.array(False),
                   jnp.full((max_it + 1, mu), -1.0, dtype=rdtype))
    final = lax.while_loop(lambda c: ~c.stop, cycle, carry0)
    it_per_rhs = jnp.where(final.first_it > 0, final.first_it,
                           jnp.minimum(final.it - 1, max_it))
    return KrylovResult(x=final.x, iterations=jnp.max(it_per_rhs),
                        it_per_rhs=it_per_rhs, rel_res=final.res / norm,
                        converged=final.first_it > 0, history=final.hist)


def bcg(op: LinearOperator, b: jax.Array, x0: Optional[jax.Array] = None,
        tol: float = 1.0e-6, max_it: int = 100,
        deflation_tol: float = -1.0) -> KrylovResult:
    """Block CG with pseudo-inverse breakdown handling
    (HPDDM_CG.hpp:170-341)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    rdtype = underlying(b.dtype)
    mu = b.shape[-1]
    rtol = 1e-12 if deflation_tol <= 0 else deflation_tol

    norm = _init_norm(op, b, rdtype)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    class Carry(NamedTuple):
        x: jax.Array
        r: jax.Array
        p: jax.Array
        it: jax.Array
        first_it: jax.Array
        res: jax.Array
        hist: jax.Array

    r0 = b - op.gmv(x0)
    z0 = op.apply(r0)

    def cond(c: Carry):
        return (c.it <= max_it) & jnp.any(c.first_it == 0)

    def body(c: Carry) -> Carry:
        Ap = op.gmv(c.p)
        pAp = _block_dot(op, c.p, Ap)
        pinv = _psd_pinv(pAp, rtol)
        alpha = pinv @ _block_dot(op, c.p, c.r)
        x = c.x + jnp.einsum("sna,ab->snb", c.p, alpha)
        r = c.r - jnp.einsum("sna,ab->snb", Ap, alpha)
        z = op.apply(r)
        beta = -(pinv @ _block_dot(op, Ap, z))
        p = z + jnp.einsum("sna,ab->snb", c.p, beta)
        res = jnp.sqrt(jnp.abs(jnp.diagonal(_block_dot(op, r, r)))).astype(rdtype)
        crossed = res <= tol * norm
        first_new = jnp.where((c.first_it == 0) & crossed, c.it, c.first_it)
        hist = c.hist.at[jnp.minimum(c.it, max_it)].set(
            (res / norm).astype(c.hist.dtype))
        return Carry(x, r, p, c.it + 1, first_new, res / norm, hist)

    carry0 = Carry(x0, r0, z0, jnp.int32(1), jnp.zeros((mu,), jnp.int32),
                   jnp.full((mu,), jnp.inf, dtype=rdtype),
                   jnp.full((max_it + 1, mu), -1.0, dtype=rdtype))
    f = lax.while_loop(cond, body, carry0)
    it_per_rhs = jnp.where(f.first_it > 0, f.first_it,
                           jnp.minimum(f.it - 1, max_it))
    return KrylovResult(x=f.x, iterations=jnp.max(it_per_rhs),
                        it_per_rhs=it_per_rhs, rel_res=f.res,
                        converged=f.first_it > 0, history=f.hist)


def bfbcg(op: LinearOperator, b: jax.Array, x0: Optional[jax.Array] = None,
          tol: float = 1.0e-6, max_it: int = 100,
          deflation_tol: float = 1.0e-4, qr: str = "cholqr") -> KrylovResult:
    """Breakdown-free block CG (HPDDM_CG.hpp:343-484): directions are
    M-orthonormalized each step and near-dependent ones deflated by the
    pseudo-inverse truncation at ``deflation_tol``."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    rdtype = underlying(b.dtype)
    mu = b.shape[-1]
    dtol = deflation_tol if deflation_tol > 0 else 1e-8

    norm = _init_norm(op, b, rdtype)
    norm = jnp.where(norm < HPDDM_EPS, 1.0, norm)

    class Carry(NamedTuple):
        x: jax.Array
        r: jax.Array
        p: jax.Array
        it: jax.Array
        first_it: jax.Array
        res: jax.Array
        hist: jax.Array

    r0 = b - op.gmv(x0)
    p0, _ = _qr(op, op.apply(r0), qr, rtol=dtol)

    def cond(c: Carry):
        return (c.it <= max_it) & jnp.any(c.first_it == 0)

    def body(c: Carry) -> Carry:
        Ap = op.gmv(c.p)
        pAp = _block_dot(op, c.p, Ap)
        pinv = _psd_pinv(pAp, dtol)
        alpha = pinv @ _block_dot(op, c.p, c.r)
        x = c.x + jnp.einsum("sna,ab->snb", c.p, alpha)
        r = c.r - jnp.einsum("sna,ab->snb", Ap, alpha)
        z = op.apply(r)
        beta = -(pinv @ _block_dot(op, Ap, z))
        p_new = z + jnp.einsum("sna,ab->snb", c.p, beta)
        p_new, _ = _qr(op, p_new, qr, rtol=dtol)
        res = jnp.sqrt(jnp.abs(jnp.diagonal(_block_dot(op, r, r)))).astype(rdtype)
        crossed = res <= tol * norm
        first_new = jnp.where((c.first_it == 0) & crossed, c.it, c.first_it)
        hist = c.hist.at[jnp.minimum(c.it, max_it)].set(
            (res / norm).astype(c.hist.dtype))
        return Carry(x, r, p_new, c.it + 1, first_new, res / norm, hist)

    carry0 = Carry(x0, r0, p0, jnp.int32(1), jnp.zeros((mu,), jnp.int32),
                   jnp.full((mu,), jnp.inf, dtype=rdtype),
                   jnp.full((max_it + 1, mu), -1.0, dtype=rdtype))
    f = lax.while_loop(cond, body, carry0)
    it_per_rhs = jnp.where(f.first_it > 0, f.first_it,
                           jnp.minimum(f.it - 1, max_it))
    return KrylovResult(x=f.x, iterations=jnp.max(it_per_rhs),
                        it_per_rhs=it_per_rhs, rel_res=f.res,
                        converged=f.first_it > 0, history=f.hist)
