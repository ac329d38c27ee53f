"""Parametric plate-mesh generators.

Replaces the FreeFEM ``buildmesh`` templates
(reference jax_plate/geometry/symm.edp:24-33 and sh_i.edp:22-31):
a rectangular strip, clamped on one short side (label 1), with the
accelerometer-circle embedded in the mesh so the indicator-weighted mass
corrections integrate cleanly.

Method: fixed boundary + circle ring points (discretisation counts mirror the
templates), hexagonal-lattice interior seeds, scipy Delaunay over a convex
domain, then a few Laplacian smoothing / re-triangulation sweeps.  The result
is a static node/triangle array set — mesh is data, not a process.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from .core import TriangleMesh


def _ring_points(cx: float, cy: float, r: float, n: int, t0: float = 0.0) -> np.ndarray:
    t = t0 + 2.0 * np.pi * np.arange(n) / n
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=1)


def _segment_points(p0, p1, n: int, include_first=True, include_last=False) -> np.ndarray:
    """n segments from p0 to p1 -> n+1 points; endpoints optional."""
    t = np.linspace(0.0, 1.0, n + 1)
    pts = np.outer(1 - t, p0) + np.outer(t, p1)
    sl = slice(0 if include_first else 1, None if include_last else -1)
    return pts[sl]


def _hex_lattice(xmin, xmax, ymin, ymax, h: float) -> np.ndarray:
    """Hexagonal interior lattice with spacing ~h."""
    rows = []
    dy = h * np.sqrt(3.0) / 2.0
    ny = max(int(np.floor((ymax - ymin) / dy)), 1)
    for j in range(ny + 1):
        y = ymin + j * dy
        if y > ymax + 1e-12:
            break
        off = 0.5 * h if (j % 2) else 0.0
        xs = np.arange(xmin + off, xmax + 1e-12, h)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
    return np.concatenate(rows, axis=0) if rows else np.zeros((0, 2))


def _dedupe(points: np.ndarray, tol: float) -> np.ndarray:
    """Remove points closer than tol to an earlier point (stable order)."""
    kept: list[np.ndarray] = []
    grid: dict[tuple[int, int], list[int]] = {}
    inv = 1.0 / tol
    for p in points:
        key = (int(np.floor(p[0] * inv)), int(np.floor(p[1] * inv)))
        ok = True
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for idx in grid.get((key[0] + dx, key[1] + dy), ()):
                    if np.hypot(*(kept[idx] - p)) < tol:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid.setdefault(key, []).append(len(kept))
            kept.append(p)
    return np.asarray(kept)


def _filter_near(candidates: np.ndarray, fixed: np.ndarray, min_dist: float) -> np.ndarray:
    """Drop candidate points within min_dist of any fixed point."""
    if candidates.size == 0 or fixed.size == 0:
        return candidates
    from scipy.spatial import cKDTree

    tree = cKDTree(fixed)
    d, _ = tree.query(candidates, k=1)
    return candidates[d >= min_dist]


def _smooth(points: np.ndarray, n_fixed: int, iters: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """Laplacian smoothing of the movable points on the Delaunay graph."""
    pts = points.copy()
    tri = None
    for _ in range(iters):
        tri = Delaunay(pts)
        simplices = tri.simplices
        V = pts.shape[0]
        acc = np.zeros((V, 2))
        cnt = np.zeros(V)
        for i in range(3):
            for j in range(3):
                if i == j:
                    continue
                np.add.at(acc, simplices[:, i], pts[simplices[:, j]])
                np.add.at(cnt, simplices[:, i], 1.0)
        new = acc / np.maximum(cnt, 1.0)[:, None]
        pts[n_fixed:] = new[n_fixed:]
    tri = Delaunay(pts)
    return pts, tri.simplices


def rectangle_with_circle(
    Lx: float,
    Ly: float,
    r_accel: float,
    cx: float,
    cy: float,
    *,
    ny: int = 3,
    nx: int | None = None,
    n_accel: int | None = None,
    n_side_left: int | None = None,
    n_side_right: int | None = None,
    smooth_iters: int = 6,
) -> TriangleMesh:
    """Rectangle [0,Lx] x [-Ly/2, Ly/2] with an embedded circle.

    Discretisation defaults mirror symm.edp:20-22 (nx = 15*ny,
    n_accel = 4*ny, 3*ny nodes per short side).  The right short side
    (x == Lx) is the clamped Dirichlet border, label 1 (symm.edp:26).
    """
    if nx is None:
        nx = 15 * ny
    if n_accel is None:
        n_accel = 4 * ny
    if n_side_left is None:
        n_side_left = 3 * ny
    if n_side_right is None:
        n_side_right = 3 * ny

    y0, y1 = -Ly / 2.0, Ly / 2.0
    h = min(Ly / max(n_side_left, 1), Lx / max(nx, 1))

    # --- fixed boundary chain (CCW): left, bottom, right, top ------------
    bnd = np.concatenate(
        [
            _segment_points([0, y1], [0, y0], n_side_left),
            _segment_points([0, y0], [Lx, y0], nx),
            _segment_points([Lx, y0], [Lx, y1], n_side_right),
            _segment_points([Lx, y1], [0, y1], nx),
        ]
    )

    # --- circle ring(s) ---------------------------------------------------
    # Round the ring count up to a multiple of 4 so that, when the circle is
    # tangent to the rectangle (the sh_i template, sh_i.edp:11-12), the exact
    # tangency points are ring points and land on the boundary.
    n_accel = int(4 * np.ceil(n_accel / 4))
    ring = _ring_points(cx, cy, r_accel, n_accel, t0=np.pi / 2)
    h_ring = 2 * np.pi * r_accel / n_accel

    # Snap near-boundary ring points onto the rectangle and clear non-corner
    # boundary points that crowd the ring (prevents boundary slivers).
    snap = 0.3 * h_ring
    ring[:, 0] = np.where(np.abs(ring[:, 0] - 0.0) < snap, 0.0, ring[:, 0])
    ring[:, 0] = np.where(np.abs(ring[:, 0] - Lx) < snap, Lx, ring[:, 0])
    ring[:, 1] = np.where(np.abs(ring[:, 1] - y0) < snap, y0, ring[:, 1])
    ring[:, 1] = np.where(np.abs(ring[:, 1] - y1) < snap, y1, ring[:, 1])

    corners = np.array([[0, y0], [Lx, y0], [Lx, y1], [0, y1]], dtype=np.float64)
    is_corner = np.zeros(bnd.shape[0], dtype=bool)
    for cpt in corners:
        is_corner |= np.hypot(bnd[:, 0] - cpt[0], bnd[:, 1] - cpt[1]) < 1e-12
    from scipy.spatial import cKDTree

    d_ring, _ = cKDTree(ring).query(bnd, k=1)
    bnd = bnd[is_corner | (d_ring >= 0.6 * h_ring)]

    fixed = _dedupe(np.concatenate([bnd, ring]), tol=0.25 * min(h, h_ring))

    # keep fixed points strictly inside the closed rectangle
    fixed[:, 0] = np.clip(fixed[:, 0], 0.0, Lx)
    fixed[:, 1] = np.clip(fixed[:, 1], y0, y1)
    n_fixed = fixed.shape[0]

    # --- interior seeds ---------------------------------------------------
    margin = 0.45 * h
    interior = _hex_lattice(margin, Lx - margin, y0 + margin, y1 - margin, h)
    # thin out near the circle so ring edges survive Delaunay
    d_circ = np.abs(np.hypot(interior[:, 0] - cx, interior[:, 1] - cy) - r_accel)
    interior = interior[d_circ >= 0.55 * h_ring]
    interior = _filter_near(interior, fixed, 0.55 * h)

    pts = np.concatenate([fixed, interior]) if interior.size else fixed
    pts, simplices = _smooth(pts, n_fixed, iters=smooth_iters)

    # drop degenerate slivers (zero area after smoothing)
    p = pts[simplices]
    areas = 0.5 * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    )
    simplices = simplices[areas > 1e-12 * Lx * Ly]

    mesh = TriangleMesh(pts, simplices)
    tol = 1e-9 * max(Lx, Ly)
    mesh.label_boundary(lambda x, y: np.abs(x - Lx) < tol, label=1)
    return mesh


def generate_plate_mesh(
    template: str,
    length: float,
    width: float,
    r_accel: float,
    accel_x: float | None = None,
    accel_y: float | None = None,
    *,
    ny: int | None = None,
    refine: float = 1.0,
) -> TriangleMesh:
    """Template dispatch mirroring the reference's Geometry templates
    (reference Geometry.py:10, 41-48; geometry/symm.edp, sh_i.edp).

    Templates ('symm'/'sh_i'/'sh_r') use the rectangle frame
    x in [0, length], y in [-width/2, width/2]; the clamped border (label 1)
    is the short side x == length.

    * 'symm': circle centred at (accel_x, 0) — symm.edp:31.
    * 'sh_i': circle tangent to the free corner, centre
      (r_accel, width/2 - r_accel) — sh_i.edp:11-12.
    * 'sh_r': circle at a custom (accel_x, accel_y), where accel_y is measured
      from the top edge as in Geometry.py:92-94 (the stored value is already
      converted to the centred frame by the Geometry layer).

    ``refine`` scales mesh density (2.0 -> roughly half the spacing).
    """
    if template == "symm":
        if ny is None:
            ny = 3  # symm.edp:20
        ny = max(int(round(ny * refine)), 1)
        return rectangle_with_circle(
            length, width, r_accel, accel_x, 0.0,
            ny=ny, nx=15 * ny, n_accel=4 * ny,
            n_side_left=3 * ny, n_side_right=3 * ny,
        )
    elif template == "sh_i":
        if ny is None:
            ny = 2  # sh_i.edp:18
        ny = max(int(round(ny * refine)), 1)
        cx = r_accel
        cy = width / 2.0 - r_accel
        return rectangle_with_circle(
            length, width, r_accel, cx, cy,
            ny=ny, nx=15 * ny, n_accel=9 * ny,
            n_side_left=3 * ny, n_side_right=3 * ny,
        )
    elif template == "sh_r":
        # sh_r.edp is absent from the reference repo (gitignored geometry dir);
        # semantics follow Geometry.__init__ conventions for TEMPLATES[0].
        if ny is None:
            ny = 3
        ny = max(int(round(ny * refine)), 1)
        return rectangle_with_circle(
            length, width, r_accel, accel_x, accel_y,
            ny=ny, nx=15 * ny, n_accel=6 * ny,
            n_side_left=3 * ny, n_side_right=3 * ny,
        )
    else:
        raise ValueError(
            f"Unknown mesh template {template!r}; options: 'symm', 'sh_i', 'sh_r'."
        )
