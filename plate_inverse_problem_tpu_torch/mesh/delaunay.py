"""Unstructured planar meshing: Delaunay domains from border loops.

Replaces the reference's reliance on FreeFEM's ``buildmesh`` for arbitrary
user domains (reference jax_plate/Geometry.py:115-145;
geometry/symm.edp:24-33): the caller provides discretized border loops
(polylines with per-segment labels, CCW for outer boundaries, CW for
holes — the FreeFEM orientation convention), and this module fills the
interior with a quasi-uniform point set, triangulates (scipy Delaunay),
removes outside/hole triangles, recovers any missing boundary segments,
and optionally smooths interior points for element quality.

A ``seed``/``jitter`` knob perturbs the interior lattice, producing
independent mesh *realizations* at the same density — the tool behind the
golden-parity scatter study (the JAX package's diagnostics/parity.py): the reference's own
buildmesh interior is exactly such an arbitrary realization.
"""
from __future__ import annotations

import numpy as np

from .core import TriangleMesh


def border(fn, t0: float, t1: float, n: int, label: int = 0):
    """Discretize a parametric border arc — the FreeFEM ``border`` analog.

    ``fn(t) -> (x, y)`` vectorized over ``t``; ``n`` segments from ``t0``
    to ``t1`` (endpoint excluded: arcs chain into closed loops).  Returns
    (points (n, 2), labels (n,)).
    """
    t = np.linspace(t0, t1, n, endpoint=False)
    x, y = fn(t)
    pts = np.stack([np.broadcast_to(x, t.shape),
                    np.broadcast_to(y, t.shape)], axis=1)
    return pts, np.full(n, label, np.int32)


def chain(*arcs):
    """Concatenate border arcs into one closed loop (points, seg_labels)."""
    pts = np.concatenate([a[0] for a in arcs], axis=0)
    labs = np.concatenate([a[1] for a in arcs], axis=0)
    return pts, labs


def _signed_area(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _contains(loop_pts, q):
    """Vectorized ray-casting point-in-polygon: q (M, 2) inside loop."""
    x, y = q[:, 0:1], q[:, 1:2]
    ax, ay = loop_pts[:, 0][None, :], loop_pts[:, 1][None, :]
    bx, by = (np.roll(loop_pts[:, 0], -1)[None, :],
              np.roll(loop_pts[:, 1], -1)[None, :])
    cond = (ay > y) != (by > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = ax + (y - ay) * (bx - ax) / (by - ay)
    crossing = cond & (x < xi)
    return (crossing.sum(axis=1) % 2).astype(bool)


def _inside_domain(loops, q):
    inside = np.zeros(q.shape[0], bool)
    for pts, _ in loops:
        hit = _contains(pts, q)
        outer = _signed_area(pts) > 0
        if outer:
            inside |= hit
    for pts, _ in loops:
        if _signed_area(pts) < 0:
            inside &= ~_contains(pts, q)
    return inside


def _boundary_samples(loops, step):
    """Points sampled densely along every border segment (clearance test)."""
    out = []
    for pts, _ in loops:
        nxt = np.roll(pts, -1, axis=0)
        seg = nxt - pts
        ln = np.linalg.norm(seg, axis=1)
        for i in range(pts.shape[0]):
            k = max(int(np.ceil(ln[i] / step)), 1)
            t = np.arange(k)[:, None] / k
            out.append(pts[i] + t * seg[i])
    return np.concatenate(out, axis=0)


def _triangulate(points):
    from scipy.spatial import Delaunay

    return Delaunay(points).simplices.astype(np.int32)


def _keep_inside(loops, points, tris):
    cen = points[tris].mean(axis=1)
    return tris[_inside_domain(loops, cen)]


def _graded_points(cand, size_field, h_uniform):
    """Greedy Poisson-disk thinning of a fine candidate lattice to honor a
    spatially-varying size field (the ``adaptmesh`` point distribution)."""
    from scipy.spatial import cKDTree

    hs = np.asarray(size_field(cand), float)
    order = np.argsort(hs)                    # densest regions claim first
    cand, hs = cand[order], hs[order]
    accepted = np.zeros((0, 2))
    acc_h = np.zeros(0)
    for i0 in range(0, cand.shape[0], 2048):
        chunk = cand[i0:i0 + 2048]
        ch = hs[i0:i0 + 2048]
        if accepted.shape[0]:
            d, j = cKDTree(accepted).query(chunk, k=1)
            keep = d >= 0.92 * np.maximum(ch, acc_h[j])
            chunk, ch = chunk[keep], ch[keep]
        # intra-chunk spacing
        sel = np.ones(chunk.shape[0], bool)
        tree = cKDTree(chunk)
        for a, b in sorted(tree.query_pairs(float(ch.max() if ch.size else 0))):
            if sel[a] and sel[b]:
                if np.linalg.norm(chunk[a] - chunk[b]) < \
                        0.92 * max(ch[a], ch[b]):
                    sel[b] = False
        accepted = np.concatenate([accepted, chunk[sel]])
        acc_h = np.concatenate([acc_h, ch[sel]])
    return accepted


def build_mesh(loops, h: float | None = None, *, smooth: int = 4,
               seed: int | None = None, jitter: float = 0.0,
               max_recovery: int = 8, size_field=None,
               h_min: float | None = None) -> TriangleMesh:
    """Mesh the domain bounded by ``loops``.

    ``loops``: list of ``(points (N, 2), seg_labels (N,))`` closed polylines
    (segment i joins point i to i+1 mod N); CCW = outer boundary, CW = hole.
    ``h``: target interior spacing (default: median border segment length).
    ``smooth``: Laplacian smoothing passes on interior points.
    ``seed``/``jitter``: perturb the interior lattice by ``jitter * h`` —
    independent realizations for convergence/scatter studies.
    ``size_field``: optional callable ``(M, 2) -> (M,)`` giving the local
    target spacing — metric-driven grading, the counterpart of FreeFEM's
    ``adaptmesh`` (reference pyFreeFem/functions.py:93-136);
    ``h_min`` floors it (default h/8).
    """
    loops = [(np.asarray(p, np.float64), np.asarray(l, np.int32))
             for p, l in loops]
    bpts = np.concatenate([p for p, _ in loops], axis=0)
    if h is None:
        seg_len = np.concatenate([
            np.linalg.norm(np.roll(p, -1, axis=0) - p, axis=1)
            for p, _ in loops
        ])
        h = float(np.median(seg_len))

    # hexagonal interior lattice, jittered, kept clear of the boundary
    from scipy.spatial import cKDTree

    lo = bpts.min(axis=0)
    hi = bpts.max(axis=0)
    h_lattice = h
    if size_field is not None:
        floor = h_min if h_min is not None else h / 8.0
        h_lattice = float(floor)

    def hex_lattice(step):
        dy = step * np.sqrt(3.0) / 2.0
        out = []
        for j, yv in enumerate(np.arange(lo[1] + 0.5 * dy, hi[1], dy)):
            xo = lo[0] + (0.25 + 0.5 * (j % 2)) * step
            xs = np.arange(xo, hi[0], step)
            out.append(np.stack([xs, np.full_like(xs, yv)], axis=1))
        return np.concatenate(out, axis=0) if out else np.zeros((0, 2))

    cand = hex_lattice(h_lattice)
    if jitter and cand.size:
        rng = np.random.default_rng(seed)
        cand = cand + jitter * h_lattice * rng.uniform(-0.5, 0.5, cand.shape)
    if cand.size:
        cand = cand[_inside_domain(loops, cand)]
    if size_field is not None and cand.size:
        sf = lambda q: np.clip(  # noqa: E731
            np.asarray(size_field(np.asarray(q)), float), h_lattice, None)
        cand = _graded_points(cand, sf, h)
    if cand.size:
        local_h = (np.full(cand.shape[0], h) if size_field is None
                   else np.minimum(sf(cand), h))
        guard = cKDTree(_boundary_samples(loops, h / 2.0))
        d, _ = guard.query(cand, k=1)
        cand = cand[d >= 0.62 * local_h]

    nb = bpts.shape[0]

    # boundary segments (global point indexing) and their labels
    segs, seg_labels = [], []
    off = 0
    for p, l in loops:
        m = p.shape[0]
        idx = np.arange(m)
        segs.append(np.stack([off + idx, off + (idx + 1) % m], axis=1))
        seg_labels.append(l)
        off += m
    segs = np.concatenate(segs, axis=0)
    seg_labels = np.concatenate(seg_labels, axis=0)

    # unify coincident border points: a tangent internal border (e.g. the
    # accelerometer circle touching a plate edge, sh_i.edp) shares exact
    # points with the outer loop — duplicates would make degenerate
    # triangles.  Keep the first occurrence, remap segments, drop any
    # zero-length segment this produces.
    scale = float(max(np.ptp(bpts, axis=0)))
    tree0 = cKDTree(bpts)
    remap = np.arange(nb)
    for i, j in sorted(tree0.query_pairs(1e-12 + 1e-9 * scale)):
        remap[max(i, j)] = remap[min(i, j)]
    if (remap != np.arange(nb)).any():
        keep_mask = remap == np.arange(nb)
        new_idx = np.cumsum(keep_mask) - 1
        remap = new_idx[remap]
        bpts = bpts[keep_mask]
        segs = remap[segs]
        live = segs[:, 0] != segs[:, 1]
        segs, seg_labels = segs[live], seg_labels[live]
        nb = bpts.shape[0]

    points = np.concatenate([bpts, cand], axis=0)

    def missing_segments(tris):
        # returns the list of REQUIRED boundary segments absent from tris
        # (empty/falsy = all segments present)
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                            tris[:, [2, 0]]], axis=0)
        e = np.sort(e, axis=1)
        have = set(map(tuple, e.tolist()))
        missing = [i for i, s in enumerate(np.sort(segs, axis=1).tolist())
                   if tuple(s) not in have]
        return missing

    tris = _keep_inside(loops, points, _triangulate(points))
    for _ in range(max_recovery):
        missing = missing_segments(tris)
        if not missing:
            break
        # a missing border segment means an interior point crowds it or a
        # long segment got cut — split those segments at their midpoints
        new_pts, new_segs, new_labels = [], [], []
        drop = set(missing)
        for i in missing:
            a, b = segs[i]
            mid = 0.5 * (points[a] + points[b])
            # midpoints are inserted at the end of the BOUNDARY block
            # (position nb + k); segment endpoints are always boundary
            # points (< nb), so existing indices never shift
            j = nb + len(new_pts)
            new_pts.append(mid)
            new_segs += [[a, j], [j, b]]
            new_labels += [seg_labels[i], seg_labels[i]]
        keep = [i for i in range(segs.shape[0]) if i not in drop]
        nb_new = len(new_pts)
        points = np.concatenate(
            [points[:nb], np.asarray(new_pts), points[nb:]], axis=0)
        segs = np.concatenate(
            [segs[keep], np.asarray(new_segs, segs.dtype)], axis=0)
        seg_labels = np.concatenate([seg_labels[keep], new_labels])
        nb += nb_new
        # drop interior points crowding the new boundary points
        if points.shape[0] > nb:
            t = cKDTree(points[:nb])
            d, _ = t.query(points[nb:], k=1)
            points = np.concatenate([points[:nb], points[nb:][d >= 0.5 * h]])
        tris = _keep_inside(loops, points, _triangulate(points))

    # Laplacian smoothing of interior points (boundary fixed).  Each pass
    # re-triangulates, which can re-break a recovered border segment when a
    # smoothed interior point crowds the boundary — a silently dropped
    # segment would silently drop its label (e.g. the clamped edge), so a
    # pass that breaks recovery is rolled back and smoothing stops there.
    for _ in range(smooth):
        V = points.shape[0]
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                            tris[:, [2, 0]]], axis=0)
        acc = np.zeros((V, 2))
        cnt = np.zeros(V)
        np.add.at(acc, e[:, 0], points[e[:, 1]])
        np.add.at(acc, e[:, 1], points[e[:, 0]])
        np.add.at(cnt, e[:, 0], 1.0)
        np.add.at(cnt, e[:, 1], 1.0)
        interior = np.zeros(V, bool)
        interior[nb:] = True
        upd = acc[interior] / cnt[interior, None]
        prev_points, prev_tris = points, tris
        points = points.copy()
        points[interior] = upd
        tris = _keep_inside(loops, points, _triangulate(points))
        if missing_segments(tris):
            points, tris = prev_points, prev_tris
            break

    # remove unused points (outside-removal can orphan none, but be safe)
    used = np.zeros(points.shape[0], bool)
    used[tris] = True
    used[:nb] = True
    remap = np.cumsum(used) - 1
    points = points[used]
    tris = remap[tris].astype(np.int32)
    segs = remap[segs]

    mesh = TriangleMesh(points, tris)

    # transfer segment labels to mesh edges + their endpoints
    edge_key = {tuple(sorted(e)): i for i, e in enumerate(mesh.edges.tolist())}
    for (a, b), lab in zip(segs.tolist(), seg_labels.tolist()):
        if lab == 0:
            continue
        ei = edge_key.get(tuple(sorted((a, b))))
        if ei is not None:
            mesh.edge_labels[ei] = lab
            mesh.node_labels[a] = lab
            mesh.node_labels[b] = lab
    return mesh
