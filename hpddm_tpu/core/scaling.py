"""Symmetric Jacobi (diagonal) scaling of a decomposed system.

In f32 (the GPU's working dtype): at high coefficient contrast the
local matrices reach cond ~ contrast x grid-cond, and a single-precision
factorization of such a block is meaningless (relative error ~ cond * eps
~ 1), so one-level RAS stalls regardless of the local solver. The
practitioner fix — what a production user does before handing a system to
any single-precision solver — is the symmetric diagonal scaling

    A~ = S A S,  b~ = S b,  x = S x~,  S = diag(A)^(-1/2),

which removes the coefficient magnitude from the spectrum (the scaled
matrix has unit diagonal; for channel/jump problems the remaining
conditioning is the grid's). GenEO pencils stay consistent by scaling the
Neumann matrices with the *same* S (the GEVP is invariant under congruent
transformations applied to both pencil matrices).

Works on the decomposed data directly: the local diagonal of the
generators equals the global diagonal on every duplicated row (the
overlap carries complete rows; only the zero-POU outer layer is
incomplete, and its d=0 makes its scaling irrelevant).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from hpddm_tpu.core.csr import MatrixCSR


def jacobi_scale(mats: Sequence[MatrixCSR],
                 f: Optional[Sequence[np.ndarray]] = None,
                 neumann: Optional[Sequence[MatrixCSR]] = None
                 ) -> Tuple[List[MatrixCSR], Optional[List[np.ndarray]],
                            Optional[List[MatrixCSR]], List[np.ndarray]]:
    """Scale local matrices (and RHS / Neumann matrices) symmetrically.

    Returns (scaled_mats, scaled_f, scaled_neumann, s_list) with
    s_list[k] = diag(A_k)^(-1/2); recover the solution of the original
    system as x_k = s_list[k] * x~_k (see ``unscale_solution``).
    """
    out_m, out_f, out_n, s_list = [], None, None, []
    for k, m in enumerate(mats):
        A = m.scipy(expand=True).tocsr()
        d = np.asarray(A.diagonal(), dtype=np.float64)
        s = 1.0 / np.sqrt(np.where(np.abs(d) > 0, np.abs(d), 1.0))
        s_list.append(s.astype(m.dtype))
        S = sp.diags(s)
        out_m.append(MatrixCSR((S @ A @ S).astype(m.dtype)))
    if f is not None:
        out_f = [np.asarray(fk) * s_list[k][:, None]
                 for k, fk in enumerate(f)]
    if neumann is not None:
        out_n = []
        for k, m in enumerate(neumann):
            A = m.scipy(expand=True).tocsr()
            S = sp.diags(s_list[k].astype(np.float64))
            out_n.append(MatrixCSR((S @ A @ S).astype(m.dtype)))
    return out_m, out_f, out_n, s_list


def unscale_solution(x, s_list, n_loc=None):
    """x~ (S, n_max, mu) device/host array -> x in original variables."""
    import numpy as _np
    x = _np.asarray(x)
    out = x.copy()
    for k, s in enumerate(s_list):
        out[k, : len(s)] *= s[:, None]
    return out
