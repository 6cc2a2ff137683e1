"""hpddm_tpu — a JAX domain-decomposition sparse linear-algebra framework.

A from-scratch JAX/XLA re-design of the capabilities of HPDDM
(https://github.com/hpddm/hpddm, reference layout catalogued in SURVEY.md),
run on one GPU or sharded over several:

* one- and two-level overlapping Schwarz preconditioners (RAS / ASM / ORAS /
  SORAS) with GenEO spectral coarse spaces,
* FETI and BDD substructuring,
* a Krylov suite — GMRES / Block GMRES, CG / Block CG / Breakdown-Free Block
  CG, GCRO-DR / Block GCRO-DR, Richardson — with left / right / flexible
  preconditioning and multiple simultaneous right-hand sides.

Design stance (not a port):

* a *subdomain* is one slice of a batched array; subdomains are sharded
  over a ``jax.sharding.Mesh`` axis (``shard_map``),
* MPI point-to-point halo exchange becomes an interface scatter-add +
  ``lax.psum`` (or ``ppermute`` slabs) over the device interconnect,
* the per-subdomain direct solves that HPDDM delegates to
  MUMPS/PARDISO/SuiteSparse become batched dense/banded factorizations,
* local sparse matrices use fixed-shape formats (DIA for stencils, padded
  ELL otherwise) instead of CSR,
* ARPACK shift-invert GenEO eigenproblems become batched shift-invert
  Lanczos in pure JAX,
* the coarse operator E = Zᵀ A Z is assembled with all-gathers and solved
  replicated (optionally in lower precision, mirroring
  ``HPDDM_MIXED_PRECISION``).
"""

__version__ = "0.1.0"


def _cache_location(platform):
    """Persistent XLA cache directory for ``platform``, or None.

    GPU runs cache under the fixed ``<repo>/.cache/xla`` — the path is part
    of the cache key, so it must not move between processes. The CPU keeps
    no cache: its compiles are local and fast, and XLA:CPU entries are
    host-specific machine code."""
    import os

    if platform != "gpu":
        return None
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "xla")


def _enable_persistent_compile_cache():
    """Point jax at the persistent compilation cache on the GPU.

    Set-up at scale is dominated by one-time compiles (the Lanczos GEVP
    scan, banded factorizations, the Krylov loop); a second process with
    the same shapes loads them from disk. Where ``JAX_COMPILATION_CACHE_DIR``
    (or jax's own setting) names a directory, that one is used and nothing
    is set here."""
    import os

    import jax

    if jax.config.jax_compilation_cache_dir or \
            os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    from hpddm_tpu.device import platform
    loc = _cache_location(platform())
    if not loc:
        return
    try:
        os.makedirs(loc, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", loc)
    except OSError:
        pass                        # read-only installs: just skip


_enable_persistent_compile_cache()

from hpddm_tpu.options import Options
from hpddm_tpu.core.csr import MatrixCSR
from hpddm_tpu.parallel.decomposition import Decomposition
from hpddm_tpu.precond.schwarz import Schwarz
from hpddm_tpu.solvers.krylov import solve

__all__ = [
    "Options",
    "MatrixCSR",
    "Decomposition",
    "Schwarz",
    "solve",
    "__version__",
]
