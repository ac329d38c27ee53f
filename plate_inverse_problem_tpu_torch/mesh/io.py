"""FreeFEM ``.msh`` mesh import/export.

Gives exact-mesh parity with the reference when a FreeFEM-generated mesh is
available: the reference's pyFreeFem writes this format in ``savemesh``
(reference pyFreeFem/FreeFemIO.py:189-211):

    nv nt ne
    x y label          (nv lines)
    v1 v2 v3 region    (nt lines, 1-based indices)
    v1 v2 label        (ne lines, 1-based boundary edges)
"""
from __future__ import annotations

import numpy as np

from .core import TriangleMesh


def load_msh(path: str) -> TriangleMesh:
    with open(path, "r") as fh:
        tokens = fh.read().split()
    it = iter(tokens)
    nv, nt, ne = int(next(it)), int(next(it)), int(next(it))

    nodes = np.zeros((nv, 2), dtype=np.float64)
    node_labels = np.zeros(nv, dtype=np.int32)
    for i in range(nv):
        nodes[i, 0] = float(next(it))
        nodes[i, 1] = float(next(it))
        node_labels[i] = int(float(next(it)))

    triangles = np.zeros((nt, 3), dtype=np.int32)
    for i in range(nt):
        triangles[i] = [int(next(it)) - 1, int(next(it)) - 1, int(next(it)) - 1]
        next(it)  # region tag

    bedges = np.zeros((ne, 2), dtype=np.int32)
    blabels = np.zeros(ne, dtype=np.int32)
    for i in range(ne):
        bedges[i] = [int(next(it)) - 1, int(next(it)) - 1]
        blabels[i] = int(float(next(it)))

    mesh = TriangleMesh(nodes, triangles, node_labels=node_labels)
    # transfer per-edge labels onto the unique-edge numbering
    key = {tuple(sorted(e)): lab for e, lab in zip(bedges.tolist(), blabels.tolist())}
    for ei in range(mesh.num_edges):
        lab = key.get(tuple(mesh.edges[ei].tolist()))
        if lab is not None:
            mesh.edge_labels[ei] = lab
    return mesh


def save_vtu(mesh: TriangleMesh, path: str, point_data: dict | None = None) -> None:
    """Write an ASCII VTK unstructured-grid (.vtu) file.

    The reference exports meshes via FreeFEM's ``savevtk`` (symm.edp:34,
    enabled by Geometry(export_vtk=True), Geometry.py:224-232); this is the
    native equivalent, with optional nodal fields (e.g. mode shapes).
    """
    V, T = mesh.num_nodes, mesh.num_triangles
    with open(path, "w") as fh:
        fh.write('<?xml version="1.0"?>\n')
        fh.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        fh.write(f'<Piece NumberOfPoints="{V}" NumberOfCells="{T}">\n')
        fh.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                 'format="ascii">\n')
        for x, y in mesh.nodes:
            fh.write(f"{x:.16g} {y:.16g} 0\n")
        fh.write("</DataArray></Points>\n<Cells>\n")
        fh.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        for t in mesh.triangles:
            fh.write(f"{t[0]} {t[1]} {t[2]}\n")
        fh.write('</DataArray>\n<DataArray type="Int32" Name="offsets" '
                 'format="ascii">\n')
        fh.write(" ".join(str(3 * (i + 1)) for i in range(T)))
        fh.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" '
                 'format="ascii">\n')
        fh.write(" ".join("5" for _ in range(T)))  # VTK_TRIANGLE
        fh.write("\n</DataArray>\n</Cells>\n")
        if point_data:
            fh.write("<PointData>\n")
            for name, vals in point_data.items():
                fh.write(f'<DataArray type="Float64" Name="{name}" '
                         'format="ascii">\n')
                fh.write(" ".join(f"{float(v):.9g}" for v in np.asarray(vals)))
                fh.write("\n</DataArray>\n")
            fh.write("</PointData>\n")
        fh.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


def save_msh(mesh: TriangleMesh, path: str) -> None:
    bidx = mesh.boundary_edges()
    with open(path, "w") as fh:
        fh.write(f"{mesh.num_nodes} {mesh.num_triangles} {bidx.size}\n")
        for (x, y), lab in zip(mesh.nodes, mesh.node_labels):
            fh.write(f"{x:.16g} {y:.16g} {int(lab)}\n")
        for t in mesh.triangles:
            fh.write(f"{t[0]+1} {t[1]+1} {t[2]+1} 0\n")
        for ei in bidx:
            a, b = mesh.edges[ei]
            fh.write(f"{a+1} {b+1} {int(mesh.edge_labels[ei])}\n")
