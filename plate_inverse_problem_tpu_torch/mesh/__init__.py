"""Mesh subsystem: host-side generation of static triangle meshes.

Host copy of the JAX package's ``mesh`` (generators, point location) for
the template path; mesh file I/O is not ported yet.
"""
from .core import TriangleMesh
from .generators import generate_plate_mesh, rectangle_with_circle
from .locate import locate_points

__all__ = [
    "TriangleMesh",
    "generate_plate_mesh",
    "rectangle_with_circle",
    "locate_points",
]
