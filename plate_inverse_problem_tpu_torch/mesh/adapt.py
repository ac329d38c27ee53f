"""Metric-driven mesh adaptation — the FreeFEM ``adaptmesh`` counterpart
(reference source/pyFreeFem/functions.py:93-136).

Builds a target-size field from a nodal solution via recovered second
derivatives (Zienkiewicz-Zhu style double P1 gradient recovery: the linear
interpolation error on an element of size h scales like h^2 |D^2 u|, so
equidistributing the error gives h(x) ~ sqrt(tol / |D^2 u(x)|)), then
remeshes the domain loops with the graded Delaunay generator.
"""
from __future__ import annotations

import numpy as np

from .core import TriangleMesh
from .delaunay import build_mesh


def _tri_gradients(mesh: TriangleMesh, u: np.ndarray) -> np.ndarray:
    """Per-triangle gradient of the P1 interpolant of nodal values."""
    t = mesh.triangles
    p = mesh.nodes
    v0, v1, v2 = p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]
    det = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
           - (v2[:, 0] - v0[:, 0]) * (v1[:, 1] - v0[:, 1]))
    b = np.stack([v1[:, 1] - v2[:, 1], v2[:, 1] - v0[:, 1],
                  v0[:, 1] - v1[:, 1]], axis=1)
    c = np.stack([v2[:, 0] - v1[:, 0], v0[:, 0] - v2[:, 0],
                  v1[:, 0] - v0[:, 0]], axis=1)
    uv = u[t]
    gx = (uv * b).sum(axis=1) / det
    gy = (uv * c).sum(axis=1) / det
    return np.stack([gx, gy], axis=1)


def _recover_nodal(mesh: TriangleMesh, tri_vals: np.ndarray) -> np.ndarray:
    """Area-weighted average of per-triangle values onto nodes."""
    areas = mesh.areas()
    V = mesh.num_nodes
    out = np.zeros((V,) + tri_vals.shape[1:])
    wsum = np.zeros(V)
    for k in range(3):
        idx = mesh.triangles[:, k]
        np.add.at(out, idx, tri_vals * areas[..., None]
                  if tri_vals.ndim > 1 else tri_vals * areas)
        np.add.at(wsum, idx, areas)
    return out / np.maximum(wsum, 1e-300)[:, None] if tri_vals.ndim > 1 \
        else out / np.maximum(wsum, 1e-300)


def size_field_from_values(mesh: TriangleMesh, u, rel_err: float = 0.02,
                           h_min: float | None = None,
                           h_max: float | None = None):
    """Target element-size field equidistributing the interpolation error
    of nodal solution ``u``.  Returns ``size(q: (M, 2)) -> (M,)``.
    """
    from scipy.spatial import cKDTree

    u = np.asarray(u, float)
    g_nodes = _recover_nodal(mesh, _tri_gradients(mesh, u))        # (V, 2)
    Hx = _recover_nodal(mesh, _tri_gradients(mesh, g_nodes[:, 0]))
    Hy = _recover_nodal(mesh, _tri_gradients(mesh, g_nodes[:, 1]))
    Hmag = np.sqrt((Hx ** 2).sum(1) + (Hy ** 2).sum(1))            # (V,)

    el = mesh.edge_lengths()
    h_cur_lo, h_cur_hi = float(el.min()), float(el.max())
    if h_max is None:
        h_max = 2.0 * h_cur_hi
    if h_min is None:
        h_min = 0.25 * h_cur_lo
    scale = rel_err * max(np.abs(u).max(), 1e-300)
    with np.errstate(divide="ignore"):
        h_nodes = np.sqrt(8.0 * scale / np.maximum(Hmag, 1e-300))
    h_nodes = np.clip(h_nodes, h_min, h_max)

    tree = cKDTree(mesh.nodes)

    def size(q):
        d, j = tree.query(np.asarray(q, float), k=3)
        w = 1.0 / np.maximum(d, 1e-300)
        return (h_nodes[j] * w).sum(axis=1) / w.sum(axis=1)

    return size


def adapted_mesh(loops, mesh: TriangleMesh, u, rel_err: float = 0.02,
                 h_min: float | None = None, h_max: float | None = None,
                 **build_kw) -> TriangleMesh:
    """Remesh ``loops`` with element sizes driven by the solution ``u`` on
    the current ``mesh`` — one cycle of the classic adapt loop."""
    sf = size_field_from_values(mesh, u, rel_err, h_min=h_min, h_max=h_max)
    el = mesh.edge_lengths()
    return build_mesh(loops, h=float(np.median(el)), size_field=sf,
                      h_min=h_min if h_min is not None else 0.25 * float(el.min()),
                      **build_kw)
