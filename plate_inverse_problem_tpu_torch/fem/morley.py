"""Morley nonconforming C1 plate element, built numerically per element.

The Morley triangle (the ``P2Morley`` space FreeFEM provides the reference,
pyFFInterface.py:28) is the full quadratic space P2 on each triangle with DOFs

* ``w(v_i)`` at the three vertices,
* ``dw/dn (m_i)`` at the three edge midpoints, with a *globally oriented*
  unit normal per edge so the DOF is single-valued across elements.

The basis is constructed numerically: in centered+scaled local coordinates
the 6x6 generalized Vandermonde ``G[d, k] = DOF_d(monomial_k)`` is inverted
(batched over all elements), giving exact polynomial coefficients.  Because
the basis is quadratic its second derivatives are constant per element, so
every bending stiffness integral is a closed-form area-weighted product — no
quadrature error.

This runs once per geometry at init time on the host (numpy, float64): the
device compute path only ever consumes the assembled flat-pattern data.
"""
from __future__ import annotations

import numpy as np

from ..mesh.core import TriangleMesh
from .quadrature import TRI_DEGREE5


def _mono_eval(xy: np.ndarray) -> np.ndarray:
    """Evaluate the 6 monomials {1, x, y, x^2, xy, y^2} at xy (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    return np.stack([np.ones_like(x), x, y, x * x, x * y, y * y], axis=-1)


def _mono_grad(xy: np.ndarray) -> np.ndarray:
    """Gradients of the 6 monomials at xy (..., 2) -> (..., 6, 2)."""
    x, y = xy[..., 0], xy[..., 1]
    zero = np.zeros_like(x)
    one = np.ones_like(x)
    gx = np.stack([zero, one, zero, 2 * x, y, zero], axis=-1)
    gy = np.stack([zero, zero, one, zero, x, 2 * y], axis=-1)
    return np.stack([gx, gy], axis=-1)


def build_morley(mesh: TriangleMesh, quad=TRI_DEGREE5) -> dict:
    """Per-element Morley basis data, batched over all triangles.

    Returns a dict of numpy arrays:

    * ``dofs``   (T, 6) int32 — global DOF ids: 3 vertex ids then V + edge ids.
    * ``area``   (T,)
    * ``d2``     (T, 6, 3) — constant [d2/dx2, d2/dy2, d2/dxdy] per basis fn.
    * ``grad_q`` (T, Q, 6, 2) — basis gradients at quadrature points (global).
    * ``phi_q``  (T, Q, 6) — basis values at quadrature points.
    * ``xq``     (T, Q, 2) — quadrature point coordinates, ``wq`` (Q,) weights
      (unit weights; multiply by area).
    * ``C``, ``centroid``, ``scale`` — basis coefficients in scaled-local
      monomials for point evaluation (interpolation operators).
    """
    V = mesh.num_nodes
    tri = mesh.triangles
    P = mesh.nodes[tri]  # (T, 3, 2)

    # global unit normal per unique edge (lower->higher vertex, rotated -90)
    ea = mesh.nodes[mesh.edges[:, 0]]
    eb = mesh.nodes[mesh.edges[:, 1]]
    t_vec = eb - ea
    t_len = np.linalg.norm(t_vec, axis=1, keepdims=True)
    n_global = np.stack([t_vec[:, 1], -t_vec[:, 0]], axis=1) / t_len  # (E, 2)

    tri_e = mesh.tri_edges  # (T, 3)
    n_loc = n_global[tri_e]  # (T, 3, 2)
    mids = 0.5 * (P[:, [1, 2, 0]] + P[:, [2, 0, 1]])  # midpoint opposite vertex i

    c0 = P.mean(axis=1)  # (T, 2)
    area = 0.5 * np.abs(
        (P[:, 1, 0] - P[:, 0, 0]) * (P[:, 2, 1] - P[:, 0, 1])
        - (P[:, 1, 1] - P[:, 0, 1]) * (P[:, 2, 0] - P[:, 0, 0])
    )
    s = np.sqrt(area)  # (T,) local length scale for conditioning

    Pl = (P - c0[:, None, :]) / s[:, None, None]
    Ml = (mids - c0[:, None, :]) / s[:, None, None]

    # G rows: vertex values, then *global* normal derivatives at edge
    # midpoints.  The 1/s chain-rule factor is essential: the edge DOF is
    # shared between elements of different size, so its meaning must be
    # element-independent (d/dn in global coordinates).
    G_v = _mono_eval(Pl)  # (T, 3, 6)
    gm = _mono_grad(Ml)  # (T, 3, 6, 2)
    G_n = np.einsum("tikd,tid->tik", gm, n_loc) / s[:, None, None]
    G = np.concatenate([G_v, G_n], axis=1)  # (T, 6, 6)
    C = np.linalg.inv(G)  # columns = basis-fn monomial coefficients

    # constant second derivatives in global coords (chain rule 1/s^2)
    d2 = np.stack([2.0 * C[:, 3, :], 2.0 * C[:, 5, :], C[:, 4, :]], axis=-1)
    d2 = d2 / (s * s)[:, None, None]  # (T, 6, 3): [wxx, wyy, wxy]

    lam_q, w_q = quad
    xq = np.einsum("qi,tid->tqd", lam_q, P)  # (T, Q, 2)
    xl = (xq - c0[:, None, :]) / s[:, None, None]
    phi_q = np.einsum("tqk,tkj->tqj", _mono_eval(xl), C)  # (T, Q, 6)
    grad_q = (
        np.einsum("tqkd,tkj->tqjd", _mono_grad(xl), C) / s[:, None, None, None]
    )

    dofs = np.concatenate([tri, V + tri_e], axis=1).astype(np.int32)  # (T, 6)

    return {
        "dofs": dofs,
        "area": area,
        "d2": d2,
        "phi_q": phi_q,
        "grad_q": grad_q,
        "xq": xq,
        "wq": np.asarray(w_q),
        "C": C,
        "centroid": c0,
        "scale": s,
        "n_dofs": V + mesh.num_edges,
    }


def morley_point_eval(mdata: dict, tri_idx: np.ndarray, points: np.ndarray):
    """Evaluate (w, w_x, w_y) basis rows at arbitrary points.

    Returns (vals, grads): vals (P, 6), grads (P, 6, 2) — contributions of the
    6 local basis functions of the containing element ``tri_idx[p]``.
    Used to build the static interpolation operators that replace FreeFEM's
    ``interpolate`` matrices (pyFFInterface.py:204-212).
    """
    C = mdata["C"][tri_idx]  # (P, 6, 6)
    c0 = mdata["centroid"][tri_idx]
    s = mdata["scale"][tri_idx]
    xl = (np.asarray(points) - c0) / s[:, None]

    vals = np.einsum("pk,pkj->pj", _mono_eval(xl), C)
    grads = np.einsum("pkd,pkj->pjd", _mono_grad(xl), C) / s[:, None, None]
    return vals, grads
