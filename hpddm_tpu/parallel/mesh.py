"""Device-mesh execution: one subdomain (or a block of subdomains) per chip.

The reference's SPMD model is one subdomain per MPI rank with raw MPI
communication (SURVEY.md §2.2). Here the subdomain batch axis is sharded
over a 1D ``jax.sharding.Mesh`` axis ``'sub'`` and the whole solve runs
inside one ``shard_map``: halo reductions become ``lax.psum`` of the small
interface buffer, dots become psums, the coarse solve is replicated.

``shard_state``/``state_pspecs`` map a SchwarzState pytree onto the mesh:
every leaf with a leading subdomain axis is sharded, the coarse matrix
inverse is replicated.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hpddm_tpu.options import Options


def make_mesh(n_devices: Optional[int] = None, axis: str = "sub") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh2d(shape, axes=("host", "sub")) -> Mesh:
    """Hierarchical 2-D mesh: ``shape = (n_hosts, subs_per_host)``.

    The subdomain batch axis is sharded over the *product* of both axes
    (host-major, matching ``P(axes)``); pass ``axis_name=axes`` (the
    tuple) to every runtime function / sharded_solve.  Collectives then
    reduce over the product; neighbor ppermute halos ride the fast inner
    axis with carry hops on the outer one (parallel/ops._ppermute_shift)
    — the analogue of the reference's intra-/inter-node comm split
    (HPDDM_coarse_operator_impl.hpp:31-134 topology-aware gathers)."""
    nh, ns = shape
    devs = jax.devices()
    if nh * ns > len(devs):
        raise ValueError(f"mesh {shape} needs {nh * ns} devices, "
                         f"have {len(devs)}")
    return Mesh(np.array(devs[: nh * ns]).reshape(nh, ns), tuple(axes))


def _is_subdomain_leaf(path_leaf, S: int) -> bool:
    x = path_leaf
    return hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == S


def _banded_pspecs(bs, axis: str):
    """PartitionSpecs for a BandedSolver: its factor/coupling arrays are
    (wy, S, ...) — the subdomain axis is axis 1 (the scan runs over wy),
    so the generic S-leading rule would replicate the ~GB factors."""
    import dataclasses
    from jax.sharding import PartitionSpec as P
    return dataclasses.replace(
        bs, Dinv=P(None, axis, None, None), cl=P(None, axis, None),
        cu=P(None, axis, None), idx_fwd=P(axis, None),
        msk_fwd=P(axis, None, None), idx_inv=P(axis, None),
        msk_inv=P(axis, None, None))


def _maybe_banded(x):
    from hpddm_tpu.ops.banded_solve import BandedSolver
    return isinstance(x, BandedSolver)


def state_pspecs(state, axis: str = "sub"):
    """PartitionSpec pytree: shard S-leading leaves, replicate the rest.

    The row-level exchange plan (dec.rowplan) indexes the *full* flattened
    batch; its leaves are always replicated even if a dimension happens to
    equal S (exchange falls back to the per-shard path under shard_map).
    """
    S = state.dec.d.shape[0]
    dec = getattr(state, "dec", None)
    plan = getattr(dec, "rowplan", None)
    replicated = ({id(leaf) for leaf in jax.tree_util.tree_leaves(plan)}
                  if plan is not None else set())
    # replicated coarse-space leaves, by field name — shape heuristics are
    # unsafe here (E2_inv can be (S, S); N_c can equal S). Eloc_inv is
    # per-block (S-leading, sharded) in bsr mode but indexed globally by
    # the replicated dense-mode preconditioner.
    co = getattr(state, "coarse", None)
    if co is not None:
        names = ["E", "E_inv", "E2_inv", "Z2", "E2", "agg_oh", "loc_idx"]
        if getattr(co, "mode", "") != "bsr":
            names.append("Eloc_inv")
        for name in names:
            leaf = getattr(co, name, None)
            replicated.update(
                id(x) for x in jax.tree_util.tree_leaves(leaf))
    def spec(x):
        if id(x) in replicated:
            return P(*([None] * getattr(x, "ndim", 0)))
        if _is_subdomain_leaf(x, S):
            return P(axis, *([None] * (x.ndim - 1)))
        return P(*([None] * getattr(x, "ndim", 0)))
    specs = jax.tree_util.tree_map(spec, state)
    if _maybe_banded(getattr(state, "solver", None)):
        import dataclasses
        specs = dataclasses.replace(
            specs, solver=_banded_pspecs(state.solver, axis))
    return specs


def shard_state(state, mesh: Mesh, axis: str = "sub"):
    """device_put the state with the proper shardings."""
    specs = state_pspecs(state, axis)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        state, specs)


def substructure_pspecs(st, axis: str = "sub"):
    """PartitionSpec pytree for a SubstructureState: shard the subdomain-
    leading leaves, replicate the (small) coarse/multiplier-space leaves.

    Coarse leaves are listed by field name — shape heuristics are unsafe
    here because nc (#kernels) can equal S (one rigid mode per subdomain).
    """
    S = st.K_pinv.shape[0]
    repl_ids = set()
    for name in ("G", "GtG_inv", "G_def", "FG_def", "GFG_inv",
                 "gtg_lo", "gtg_hi", "wsw_lo", "wsw_hi"):
        leaf = getattr(st, name)
        repl_ids.update(id(x) for x in jax.tree_util.tree_leaves(leaf))
    plan = getattr(st.dec_b, "rowplan", None)
    if plan is not None:
        repl_ids.update(id(x) for x in jax.tree_util.tree_leaves(plan))

    def spec(x):
        if id(x) in repl_ids:
            return P(*([None] * getattr(x, "ndim", 0)))
        if _is_subdomain_leaf(x, S):
            return P(axis, *([None] * (x.ndim - 1)))
        return P(*([None] * getattr(x, "ndim", 0)))

    specs = jax.tree_util.tree_map(spec, st)
    import dataclasses
    for name in ("Kb", "Kiib"):
        bs = getattr(st, name, None)
        if _maybe_banded(bs):
            specs = dataclasses.replace(
                specs, **{name: _banded_pspecs(bs, axis)})
    return specs


def shard_substructure(st, mesh: Mesh, axis: str = "sub"):
    """device_put a SubstructureState with the proper shardings."""
    specs = substructure_pspecs(st, axis)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        st, specs)


def sharded_feti_solve(st, f: jax.Array, mesh: Mesh, axis: str = "sub",
                       **kw):
    """feti_solve under shard_map (subdomains sharded over the mesh)."""
    from hpddm_tpu.precond.substructure import FetiResult, feti_solve

    specs = substructure_pspecs(st, axis)
    vec = P(axis, None, None)
    out = FetiResult(u=vec, lam=P(None, None), iterations=P(),
                     rel_res=P(None))
    fn = jax.shard_map(
        lambda s, b: feti_solve(s, b, axis_name=axis, **kw),
        mesh=mesh, in_specs=(specs, vec), out_specs=out, check_vma=False)
    return fn(st, f)


def sharded_bdd_solve(st, f: jax.Array, mesh: Mesh, axis: str = "sub",
                      **kw):
    """bdd_solve under shard_map (subdomains sharded over the mesh)."""
    from hpddm_tpu.precond.substructure import BddResult, bdd_solve

    specs = substructure_pspecs(st, axis)
    vec = P(axis, None, None)
    out = BddResult(u=vec, iterations=P(), rel_res=P(None))
    fn = jax.shard_map(
        lambda s, b: bdd_solve(s, b, axis_name=axis, **kw),
        mesh=mesh, in_specs=(specs, vec), out_specs=out, check_vma=False)
    return fn(st, f)


def sharded_solve(state, b: jax.Array, opt: Options, mesh: Mesh,
                  axis: str = "sub", x0: Optional[jax.Array] = None):
    """Run the full Krylov solve under shard_map over the subdomain axis.

    The number of subdomains must be divisible by the mesh size. Returns a
    KrylovResult whose x is sharded, scalars replicated.
    """
    from hpddm_tpu.solvers.krylov import solve as _solve

    specs = state_pspecs(state, axis)
    vec_spec = P(axis, None, None)
    scal_spec = P()
    out_specs_result = type(b)  # placeholder, replaced below

    def run(st, bb):
        res = _solve(st, bb, opt=opt, axis_name=axis)
        return res

    from hpddm_tpu.solvers.gmres import KrylovResult
    out_specs = KrylovResult(x=vec_spec, iterations=scal_spec,
                             it_per_rhs=scal_spec, rel_res=scal_spec,
                             converged=scal_spec, history=scal_spec)
    fn = jax.shard_map(run, mesh=mesh, in_specs=(specs, vec_spec),
                       out_specs=out_specs, check_vma=False)
    return fn(state, b)
