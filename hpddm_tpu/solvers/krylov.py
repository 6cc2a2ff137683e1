"""Krylov method dispatch — the analogue of ``IterativeMethod::solve``
(include/HPDDM_iterative.hpp:1020-1111).

``solve(A, b, x0, opt)`` unpacks the options (krylov_method, tol, max_it,
restart, variant, orthogonalization, ...) and dispatches to the method
implementations. ``A`` is a ``SchwarzState`` (wrapped automatically into a
LinearOperator), or any ``LinearOperator`` for matrix-free use
(``CustomOperator`` equivalent).
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from hpddm_tpu.options import Options
from hpddm_tpu.solvers.base import LinearOperator
from hpddm_tpu.solvers.gmres import KrylovResult, gmres


def make_operator(A, axis_name: Optional[str] = None) -> LinearOperator:
    """Wrap a SchwarzState (or pass through a LinearOperator)."""
    from hpddm_tpu.precond import schwarz as _schwarz
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, _schwarz.SchwarzState):
        norm_filter = None
        if A.bc is not None:
            from hpddm_tpu.dtypes import HPDDM_EPS, HPDDM_PEN

            def norm_filter(b, _bc=A.bc):
                # initializeNorm (HPDDM_iterative.hpp:455-470): penalty
                # entries contribute b_i / PEN to the reference norm
                big = (jnp.abs(_bc[:, :, None]) > HPDDM_EPS) & \
                      (jnp.abs(b) > HPDDM_EPS * HPDDM_PEN)
                return jnp.where(big, b / HPDDM_PEN, b)
        return LinearOperator(
            gmv=lambda x: _schwarz.gmv(A, x, axis_name),
            apply=lambda x: _schwarz.apply(A, x, axis_name),
            weight=A.dec.d,
            axis_name=axis_name,
            norm_filter=norm_filter,
        )
    raise TypeError(f"cannot build an operator from {type(A)}")


def solve(A, b: jax.Array, x0: Optional[jax.Array] = None,
          opt: Optional[Options] = None,
          axis_name: Optional[str] = None,
          prefix: str = "") -> KrylovResult:
    """Dispatch on ``-hpddm_krylov_method`` (HPDDM_iterative.hpp:1020-1111).

    b/x0 and the returned x use the caller's numbering: renumbered
    decompositions (the interface-first layout) permute on entry and
    unpermute on exit — two gathers per *solve*, not per iteration."""
    from hpddm_tpu.precond import schwarz as _schwarz
    dec = A.dec if isinstance(A, _schwarz.SchwarzState) else None
    if dec is not None and dec.renumbered:
        if b.ndim == 2:
            b = b[:, :, None]
        b = dec.permute(b)
        if x0 is not None:
            if x0.ndim == 2:
                x0 = x0[:, :, None]
            x0 = dec.permute(x0)
        res = _solve_core(A, b, x0, opt, axis_name, prefix)
        return res._replace(x=dec.unpermute(res.x))
    return _solve_core(A, b, x0, opt, axis_name, prefix)


def _solve_core(A, b: jax.Array, x0: Optional[jax.Array],
                opt: Optional[Options],
                axis_name: Optional[str],
                prefix: str = "") -> KrylovResult:
    """Dispatch in the operator's internal numbering."""
    if opt is None:
        opt = Options()
    opt.warn_inert()
    op = make_operator(A, axis_name)
    method = opt.val("krylov_method", prefix=prefix)
    tol = float(opt.val("tol", prefix=prefix))
    max_it = int(opt.val("max_it", prefix=prefix))
    variant = opt.val("variant", prefix=prefix)
    ortho = opt.val("orthogonalization", prefix=prefix)
    if not opt.set("orthogonalization", prefix=prefix) and \
            b.dtype in (jnp.float32.dtype, jnp.bfloat16.dtype,
                        jnp.complex64.dtype):
        # f32 default is iterated CGS: plain CGS over long bases loses
        # orthogonality below f64 (the elasticity flagship stalled at
        # restart 60 with cgs; cgs2 costs one extra fused Gram psum and
        # tracks MGS iterations without its k-psum latency — PERF.md)
        ortho = "cgs2"
    qr_kind = opt.val("qr", prefix=prefix)

    if b.ndim == 2:  # (S, n) convenience -> single RHS
        b = b[:, :, None]

    from hpddm_tpu.precond import schwarz as _schwarz
    if (x0 is None and isinstance(A, _schwarz.SchwarzState)
            and A.bc is not None):
        # Schwarz::start (HPDDM_schwarz.hpp:496-514): seed the initial
        # guess exactly on detected Dirichlet rows
        x0 = _schwarz.start(A, b, axis_name=axis_name)
        if x0 is not None and x0.ndim == 2:
            x0 = x0[:, :, None]

    # enlarged Krylov: split one RHS into k slices solved as a block
    # (HPDDM_iterative.hpp:735-853)
    enlarge = opt.val("enlarge_krylov_subspace")
    if enlarge and int(enlarge) > 1 and b.shape[-1] == 1 and \
            method in ("gmres", "bgmres", "cg", "bcg", "bfbcg"):
        from hpddm_tpu.precond import schwarz as _schwarz
        from hpddm_tpu.solvers.enlarged import preprocess, postprocess
        if isinstance(A, _schwarz.SchwarzState):
            k = int(enlarge)
            slices = preprocess(A.dec, b, k, axis_name)
            inner = opt.copy()
            inner.remove("enlarge_krylov_subspace")
            if method in ("gmres", "cg"):
                inner["krylov_method"] = {"gmres": "bgmres", "cg": "bcg"}[method]
            res = _solve_core(A, slices, None, inner, axis_name, prefix)
            x = postprocess(res.x)
            return res._replace(x=x, it_per_rhs=res.it_per_rhs[:1],
                                rel_res=res.rel_res[:1],
                                converged=res.converged.all()[None])

    if method == "gmres":
        from hpddm_tpu.precond import schwarz as _sz
        if isinstance(A, _sz.SchwarzState) and A.coarse is not None \
                and variant != "flexible" \
                and (A.coarse.mode in ("iterative", "bsr")
                     or A.coarse.E_inv.dtype != b.dtype):
            # inexact coarse solves (nested Krylov) or reduced-precision
            # coarse casts make M^-1 effectively vary between applications;
            # flexible GMRES absorbs it (the reference's multilevel /
            # HPDDM_MIXED_PRECISION runs use -hpddm_variant flexible)
            variant = "flexible"
        return gmres(op, b, x0, tol=tol,
                     restart=int(opt.val("gmres_restart")),
                     max_it=max_it, variant=variant,
                     ortho=ortho)
    if method == "cg":
        from hpddm_tpu.precond import schwarz as _sz
        if isinstance(A, _sz.SchwarzState) and \
                not int(opt.val("operator_spd", 0)):
            nonsym = A.variant in ("ras", "oras") or (
                A.coarse is not None
                and A.coarse.correction in ("deflated", "balanced"))
            if nonsym:
                # CG requires an SPD preconditioner; RAS and the deflated/
                # balanced corrections are nonsymmetric — fall back to
                # GMRES like the reference (HPDDM_CG.hpp:40-42)
                return gmres(op, b, x0, tol=tol,
                             restart=int(opt.val("gmres_restart")),
                             max_it=max_it, variant=variant,
                             ortho=ortho)
        from hpddm_tpu.solvers.cg import cg
        return cg(op, b, x0, tol=tol, max_it=max_it, variant=variant)
    if method == "richardson":
        from hpddm_tpu.solvers.richardson import richardson
        return richardson(op, b, x0, tol=tol, max_it=max_it,
                          damping=float(opt.val("richardson_damping_factor")))
    if method == "bgmres":
        from hpddm_tpu.solvers.block import bgmres
        return bgmres(op, b, x0, tol=tol,
                      restart=int(opt.val("gmres_restart")),
                      max_it=max_it, variant=variant,
                      ortho=ortho,
                      deflation_tol=opt.val("deflation_tol", -1.0),
                      qr=qr_kind)
    if method == "bcg":
        from hpddm_tpu.solvers.block import bcg
        return bcg(op, b, x0, tol=tol, max_it=max_it)
    if method == "bfbcg":
        from hpddm_tpu.solvers.block import bfbcg
        return bfbcg(op, b, x0, tol=tol, max_it=max_it, qr=qr_kind)
    if method in ("gcrodr", "bgcrodr"):
        # gcrodr: pseudo-block recycling — per-RHS Hessenbergs and (U, C)
        # pairs around fused operator applications (HPDDM_GCRODR.hpp:35-444);
        # bgcrodr: true block recycling (fused block Krylov space,
        # HPDDM_GCRODR.hpp:446-907) when mu > 1.
        # The recycled (U, C) pair persists across solve() calls in the
        # Options' per-prefix storage (OptionsPrefix::storage_,
        # HPDDM_option.hpp:444-461); -hpddm_recycle_same_system skips the
        # re-projection of the stored space (HPDDM_GCRODR.hpp:435).
        recycled = opt.storage(prefix)
        same = bool(int(opt.val("recycle_same_system", 0)))
        if method == "bgcrodr" and b.shape[-1] > 1:
            from hpddm_tpu.solvers.gcrodr import bgcrodr_fused
            res = bgcrodr_fused(op, b, x0, tol=tol,
                                restart=int(opt.val("gmres_restart")),
                                max_it=max_it,
                                recycle=int(opt.val("recycle", 0)),
                                target=opt.val("recycle_target"),
                                strategy=opt.val("recycle_strategy"),
                                recycled=recycled, same_system=same,
                                deflation_tol=float(
                                    opt.val("deflation_tol", -1.0)))
        else:
            from hpddm_tpu.solvers.gcrodr import gcrodr
            res = gcrodr(op, b, x0, tol=tol,
                         restart=int(opt.val("gmres_restart")),
                         max_it=max_it, variant=variant,
                         recycle=int(opt.val("recycle", 0)),
                         target=opt.val("recycle_target"),
                         strategy=opt.val("recycle_strategy"),
                         recycled=recycled, same_system=same)
        if res.recycled is not None:
            opt.set_storage(res.recycled, prefix)
        return res
    if method == "none":
        # x = M^-1 b, one application, it = 1
        # (HPDDM_KRYLOV_METHOD_NONE, HPDDM_iterative.hpp:1056-1070)
        x = op.apply(b)
        rdtype = jnp.zeros(0, b.dtype).real.dtype
        mu = b.shape[-1]
        nb = jnp.sqrt(op.norm_sq(b))
        r = b - op.gmv(x)
        rel = (jnp.sqrt(op.norm_sq(r))
               / jnp.where(nb > 0, nb, 1.0)).astype(rdtype)
        return KrylovResult(x=x, iterations=jnp.int32(1),
                            it_per_rhs=jnp.ones((mu,), jnp.int32),
                            rel_res=rel, converged=jnp.ones((mu,), bool))
    raise ValueError(f"unknown krylov_method {method!r}")
