"""Point location: which triangle contains each query point.

Host-side, init-time only — used to build the static interpolation operators
(test-point readout and accelerometer-disk averaging), the on-device analog of
FreeFEM's ``interpolate`` matrices
(reference jax_plate/pyFFInterface.py:36-46, 200-212).
"""
from __future__ import annotations

import numpy as np

from .core import TriangleMesh


def locate_points(mesh: TriangleMesh, points: np.ndarray, tol: float = 1e-9):
    """Return (tri_index, barycentric) for each query point.

    Points outside the mesh are snapped to the triangle with the least
    negative barycentric coordinate (consistent with FreeFEM's behaviour of
    extending the FE function by the nearest element for interpolation).

    A vectorised numpy scan over the triangles for each point.
    """
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    P = mesh.nodes[mesh.triangles]  # (T, 3, 2)
    a, b, c = P[:, 0], P[:, 1], P[:, 2]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        c[:, 0] - a[:, 0]
    )

    n_pts = points.shape[0]
    tri_idx = np.zeros(n_pts, dtype=np.int32)
    bary = np.zeros((n_pts, 3), dtype=np.float64)

    for i, p in enumerate(points):
        l2 = ((p[0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (p[1] - a[:, 1]) * (c[:, 0] - a[:, 0])) / det
        l3 = ((b[:, 0] - a[:, 0]) * (p[1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (p[0] - a[:, 0])) / det
        l1 = 1.0 - l2 - l3
        lam = np.stack([l1, l2, l3], axis=1)
        worst = lam.min(axis=1)
        k = int(np.argmax(worst))
        tri_idx[i] = k
        lam_k = np.clip(lam[k], 0.0, None)
        bary[i] = lam_k / lam_k.sum()

    return tri_idx, bary
