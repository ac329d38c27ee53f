"""FEM layer: Morley C1 plate element + P1 membrane, host assembly.

Host copy of the JAX package's ``fem`` for the 3-field (laminate) path:
flat nonzero data over one static (row, col) pattern, Dirichlet reduction
and the accelerometer-disk readout rows.
"""
from .quadrature import TRI_DEGREE5
from .morley import build_morley
from .p1 import build_p1
from .assembly import SparsePattern, UnsymmOperator, assemble_unsymm

__all__ = [
    "TRI_DEGREE5",
    "build_morley",
    "build_p1",
    "SparsePattern",
    "UnsymmOperator",
    "assemble_unsymm",
]
