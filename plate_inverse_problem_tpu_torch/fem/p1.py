"""P1 (linear Lagrange) triangle element for the membrane fields u, v.

Counterpart of the reference's ``fespace Lh(Th, P1)``
(pyFFInterface.py:178-179).  Gradients are constant per element; the mass
matrix integrand is quadratic and integrated with the shared degree-5 rule so
indicator-weighted corrections see the same quadrature as the Morley terms.
"""
from __future__ import annotations

import numpy as np

from ..mesh.core import TriangleMesh
from .quadrature import TRI_DEGREE5


def build_p1(mesh: TriangleMesh, quad=TRI_DEGREE5) -> dict:
    """Per-element P1 basis data.

    Returns dict with ``dofs`` (T,3), ``area`` (T,), ``grad`` (T,3,2) constant
    gradients, ``phi_q`` (T,Q,3) values at quadrature points, ``xq``/``wq``.
    """
    tri = mesh.triangles
    P = mesh.nodes[tri]  # (T, 3, 2)
    a, b, c = P[:, 0], P[:, 1], P[:, 2]

    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        c[:, 0] - a[:, 0]
    )
    area = 0.5 * np.abs(det)

    # barycentric gradients: grad lambda_i = perp(edge_opposite_i) / det
    g = np.empty((tri.shape[0], 3, 2))
    g[:, 0, 0] = (b[:, 1] - c[:, 1]) / det
    g[:, 0, 1] = (c[:, 0] - b[:, 0]) / det
    g[:, 1, 0] = (c[:, 1] - a[:, 1]) / det
    g[:, 1, 1] = (a[:, 0] - c[:, 0]) / det
    g[:, 2, 0] = (a[:, 1] - b[:, 1]) / det
    g[:, 2, 1] = (b[:, 0] - a[:, 0]) / det

    lam_q, w_q = quad
    phi_q = np.broadcast_to(lam_q[None, :, :], (tri.shape[0],) + lam_q.shape).copy()
    xq = np.einsum("qi,tid->tqd", lam_q, P)

    return {
        "dofs": tri.astype(np.int32),
        "area": area,
        "grad": g,
        "phi_q": phi_q,
        "xq": xq,
        "wq": np.asarray(w_q),
        "n_dofs": mesh.num_nodes,
    }