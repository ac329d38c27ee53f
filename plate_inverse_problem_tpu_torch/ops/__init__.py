"""Device operators of the port: flat SpMV, RCM band layout and its CUDA
band kernel, the two-grid and multilevel preconditioners, the LOBPCG band
basis, the mixed-precision sweep, the modal and direct sweeps, and the
standalone sparse API, re-exported here as the JAX package's
``ops/__init__.py`` does.  The sweeps take the split (re, im) form of the
port's hooks, and each function whose signature differs from the JAX
one says so in its docstring.  ``jacobi_eigh`` and
``generalized_jacobi_eigh`` (the TPU's eigh workaround) are not ported."""
from .scatter import to_dense, spmv_flat
from .spectral import generalized_eigh
from .sweep import modal_sweep, direct_sweep, sweep_solve
from .mixed import mixed_sweep, band_basis_host, static_preconditioner_host
from .lobpcg import band_basis_lobpcg, lobpcg_pencil
from .sparse_api import (SymbolicPattern, create_symbolic, find_permutation,
                         matvec, spsolve, FAMILIES)

__all__ = [
    "SymbolicPattern",
    "create_symbolic",
    "find_permutation",
    "matvec",
    "spsolve",
    "FAMILIES",
    "to_dense",
    "spmv_flat",
    "generalized_eigh",
    "modal_sweep",
    "direct_sweep",
    "sweep_solve",
    "mixed_sweep",
    "band_basis_host",
    "band_basis_lobpcg",
    "lobpcg_pencil",
    "static_preconditioner_host",
]
