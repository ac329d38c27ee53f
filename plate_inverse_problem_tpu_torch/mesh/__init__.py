"""Mesh subsystem: host-side generation and import of static triangle
meshes.

Host copy of the JAX package's ``mesh``: the plate templates
(generators), point location, FreeFEM ``.edp`` geometry scripts meshed by
the Delaunay mesher (edp, delaunay) and ``.msh`` / ``.vtu`` file I/O (io).
"""
from .core import TriangleMesh
from .delaunay import build_mesh
from .edp import (
    mesh_from_edp,
    parse_dirichlet_labels,
    parse_edp_geometry,
    warn_ignored_fe_statements,
)
from .generators import generate_plate_mesh, rectangle_with_circle
from .io import load_msh, save_msh, save_vtu
from .locate import locate_points

__all__ = [
    "TriangleMesh",
    "build_mesh",
    "generate_plate_mesh",
    "load_msh",
    "locate_points",
    "mesh_from_edp",
    "parse_dirichlet_labels",
    "parse_edp_geometry",
    "rectangle_with_circle",
    "save_msh",
    "save_vtu",
    "warn_ignored_fe_statements",
]
