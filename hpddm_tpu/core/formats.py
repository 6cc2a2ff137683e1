"""Fixed-shape device sparse formats, batched over subdomains.

The reference computes local SpMV/SpMM on CSR/BSR with MKL or an OpenMP
fallback (include/HPDDM_wrapper.hpp:123-146,617-700). CSR's indirect,
variable-length rows defeat XLA's static shapes, so here the local matrices
are stored in fixed-shape formats with a leading subdomain axis ``S`` that is
sharded one-subdomain-per-chip (or batched on one chip):

* ``BatchedDIA`` — diagonal storage: for stencil matrices (structured grids)
  SpMV is ``sum_k vals[k] * shift(x, off[k])`` — elementwise, zero gathers.
  Offsets are static per problem.
* ``BatchedELL`` — padded fixed-width rows (values + column indices); SpMV is
  a take_along_axis gather + reduction. General fallback.
* ``BatchedDense`` — explicit dense blocks; SpMV is a batched matmul. Used for
  small subdomains where nnz/n^2 is not tiny, and for factorizations.

``pack_local_matrices`` builds the best format from a list of per-subdomain
host ``MatrixCSR`` (auto: DIA if the union of offsets is small, else ELL).
Rows are padded to ``n_max``; padded rows are identity rows (diagonal 1) so
factorizations stay non-singular, and padded columns carry zero values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hpddm_tpu.core.csr import MatrixCSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedDIA:
    """Diagonal-format batch: values[s, k, i] = A_s[i, i + offsets[k]].

    canvas_hw: optional (H, W) grid shape of every subdomain. When set
    (Schwarz.set_grid_geometry validates uniform boxes + seam-safe
    values), spmm uses the 2-D canvas formulation — the +-W diagonals
    become free row offsets (2.7x the flat Pallas kernel at 2048^2/16,
    PERF.md 2026-08-20)."""
    values: jax.Array                     # (S, ndiag, n_max)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_max: int = dataclasses.field(metadata=dict(static=True))
    canvas_hw: Optional[Tuple[int, int]] = dataclasses.field(
        default=None, metadata=dict(static=True))
    # optional low-precision mirror of `values` used by the SpMM hot path
    # (-hpddm_gmv_dtype bf16): halves the dominant HBM value stream; the
    # multiply accumulates in x's dtype. Setup paths (coarse assembly,
    # factorizations) always read the full-precision `values`.
    values_lp: Optional[jax.Array] = None
    # canvas symmetry map (set by Schwarz._try_canvas_annotate when the
    # matrix is exactly symmetric): canvas_sym[k] = j means plane k's
    # values are the shifted transpose of plane j (V_k[p] = V_j[p + m_k]
    # bitwise), so the canvas SpMM never reads plane k from HBM — its
    # term is the m_k-shift of (V_j * x). 5-point stencils drop from 5
    # value-plane streams to 3; the result is bitwise unchanged.
    canvas_sym: Optional[Tuple[Optional[int], ...]] = dataclasses.field(
        default=None, metadata=dict(static=True))
    # pre-split canvas-shaped value planes ((S, H, W) each, in the
    # SpMM-path dtype). Slicing the packed (S, ndiag, n) buffer *inside*
    # a jitted solve can materialize per-plane copies every scan step when
    # the operator state crosses the jit boundary as an argument.
    # Built by Schwarz._try_canvas_annotate alongside canvas_hw.
    values_planes: Optional[Tuple[jax.Array, ...]] = None

    @property
    def S(self) -> int:
        return self.values.shape[0]

    def astype(self, dtype) -> "BatchedDIA":
        return dataclasses.replace(self, values=self.values.astype(dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedELL:
    """Padded row-major ELL batch. cols padded with 0 and values with 0."""
    values: jax.Array                     # (S, n_max, width)
    cols: jax.Array                       # (S, n_max, width) int32
    n_max: int = dataclasses.field(metadata=dict(static=True))

    @property
    def S(self) -> int:
        return self.values.shape[0]

    def astype(self, dtype) -> "BatchedELL":
        return dataclasses.replace(self, values=self.values.astype(dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedDense:
    """Dense batch (S, n_max, n_max); padded rows/cols are identity."""
    values: jax.Array
    n_max: int = dataclasses.field(metadata=dict(static=True))

    @property
    def S(self) -> int:
        return self.values.shape[0]

    def astype(self, dtype) -> "BatchedDense":
        return dataclasses.replace(self, values=self.values.astype(dtype))


BatchedMatrix = (BatchedDIA, BatchedELL, BatchedDense)


def _diag_offsets(mats: Sequence[MatrixCSR],
                  cap: Optional[int] = 32) -> Optional[np.ndarray]:
    """Union of nonzero diagonals across subdomains, or None if > cap."""
    offsets: set = set()
    for m in mats:
        c = m.scipy(expand=True).tocoo()
        offsets.update(np.unique(c.col - c.row).tolist())
        if cap is not None and len(offsets) > cap:
            return None
    return np.array(sorted(offsets), dtype=np.int64)


def pack_local_matrices(mats: Sequence[MatrixCSR], n_max: Optional[int] = None,
                        fmt: str = "auto", dtype=None,
                        pad_identity: bool = True):
    """Pack per-subdomain CSR matrices into a batched device format.

    fmt in {"auto", "dia", "ell", "dense"}. Symmetric-stored inputs are
    expanded to full storage first (device formats are row-complete; the
    reference instead branches on `sym_` in every kernel).
    """
    S = len(mats)
    if n_max is None:
        n_max = max(m.n for m in mats)
    if dtype is None:
        dtype = np.result_type(*[m.dtype for m in mats])

    if fmt == "auto":
        offs = _diag_offsets(mats)
        fmt = "dia" if offs is not None else "ell"
    else:
        offs = _diag_offsets(mats, cap=None) if fmt == "dia" else None

    if fmt == "dia":
        ndiag = len(offs)
        vals = np.zeros((S, ndiag, n_max), dtype=dtype)
        off_pos = {int(o): k for k, o in enumerate(offs)}
        for s, m in enumerate(mats):
            c = m.scipy(expand=True).tocoo()
            k_idx = np.array([off_pos[int(o)] for o in (c.col - c.row)])
            vals[s, k_idx, c.row] = c.data
            if pad_identity and 0 in off_pos:
                vals[s, off_pos[0], m.n:] = 1.0
        return BatchedDIA(values=jnp.asarray(vals), offsets=tuple(int(o) for o in offs),
                          n_max=int(n_max))

    if fmt == "ell":
        from hpddm_tpu.native import ell_pack as _native_ell_pack
        width = 1
        rows_list = []
        for m in mats:
            csr = m.scipy(expand=True)
            counts = np.diff(csr.indptr)
            width = max(width, int(counts.max(initial=1)))
            rows_list.append(csr)
        vals = np.zeros((S, n_max, width), dtype=dtype)
        cols = np.zeros((S, n_max, width), dtype=np.int32)
        for s, csr in enumerate(rows_list):
            if np.issubdtype(csr.dtype, np.floating):
                csr = csr.astype(np.float64)
            v, c = _native_ell_pack(csr, n_max, width)
            vals[s] = v.astype(dtype)
            cols[s] = c
            if pad_identity:
                n = csr.shape[0]
                vals[s, n:, 0] = 1.0
                cols[s, n:, 0] = np.arange(n, n_max)
        return BatchedELL(values=jnp.asarray(vals), cols=jnp.asarray(cols),
                          n_max=int(n_max))

    if fmt == "dense":
        vals = np.zeros((S, n_max, n_max), dtype=dtype)
        for s, m in enumerate(mats):
            vals[s, : m.n, : m.n] = m.dense(expand=True)
            if pad_identity:
                idx = np.arange(m.n, n_max)
                vals[s, idx, idx] = 1.0
        return BatchedDense(values=jnp.asarray(vals), n_max=int(n_max))

    raise ValueError(f"unknown format {fmt!r}")


def batched_dense_from(mat, pad_identity_rows: Optional[jax.Array] = None) -> jax.Array:
    """Materialize any batched format as dense (S, n, n) on device."""
    if isinstance(mat, BatchedDense):
        return mat.values
    if isinstance(mat, BatchedELL):
        S, n, w = mat.values.shape
        out = jnp.zeros((S, n, n), mat.values.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[None, :, None], (S, n, w))
        return out.at[jnp.arange(S)[:, None, None], rows, mat.cols].add(mat.values)
    if isinstance(mat, BatchedDIA):
        S, nd, n = mat.values.shape
        out = jnp.zeros((S, n, n), mat.values.dtype)
        i = jnp.arange(n)
        for k, off in enumerate(mat.offsets):
            cols = i + off
            valid = (cols >= 0) & (cols < n)
            safe_cols = jnp.clip(cols, 0, n - 1)
            contrib = jnp.where(valid, mat.values[:, k, :], 0.0)
            out = out.at[:, i, safe_cols].add(contrib)
        return out
    raise TypeError(f"unsupported matrix type {type(mat)}")
