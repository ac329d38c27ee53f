"""Domain models: materials, geometry, accelerometer, Problem (the JAX
package's ``models`` names)."""
from .materials import (
    ATYPES,
    Material,
    Isotropic,
    Orthotropic,
    OrthotropicD4,
    SOL,
    SymmetricalSOL,
    get_material,
)
from .accelerometer import Accelerometer, AccelerometerParams
from .geometry import Geometry, GeometryParams
from .problem import Problem

__all__ = [
    "Accelerometer",
    "AccelerometerParams",
    "Geometry",
    "GeometryParams",
    "Problem",
    "ATYPES",
    "Material",
    "Isotropic",
    "Orthotropic",
    "OrthotropicD4",
    "SOL",
    "SymmetricalSOL",
    "get_material",
]
