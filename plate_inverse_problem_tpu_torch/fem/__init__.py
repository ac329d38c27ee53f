"""FEM layer: Morley C1 plate element + P1 membrane, host assembly.

Host copy of the JAX package's ``fem`` for both paths, the 3-field
(laminate) one and the pure-bending one: flat nonzero data over one static
(row, col) pattern, Dirichlet reduction, the accelerometer-disk readout
rows and the test-point interpolation row.
"""
from .quadrature import TRI_DEGREE2, TRI_DEGREE5
from .morley import build_morley
from .p1 import build_p1
from .assembly import (
    SparsePattern,
    SymmOperator,
    UnsymmOperator,
    assemble_symm,
    assemble_unsymm,
)

__all__ = [
    "TRI_DEGREE2",
    "TRI_DEGREE5",
    "build_morley",
    "build_p1",
    "SparsePattern",
    "SymmOperator",
    "UnsymmOperator",
    "assemble_symm",
    "assemble_unsymm",
]
