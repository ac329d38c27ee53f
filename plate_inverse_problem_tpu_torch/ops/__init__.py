"""Device operators of the port: flat SpMV, RCM band layout and its CUDA
band kernel, the two-grid and multilevel preconditioners, the LOBPCG band
basis, the mixed-precision sweep, the modal and direct sweeps, and the
standalone sparse API, re-exported here as the JAX package's
``ops/__init__.py`` does."""
from .sparse_api import (SymbolicPattern, create_symbolic, find_permutation,
                         matvec, spsolve, FAMILIES)

__all__ = [
    "SymbolicPattern",
    "create_symbolic",
    "find_permutation",
    "matvec",
    "spsolve",
    "FAMILIES",
]
