"""Triangle mesh container with edge topology.

The FEM layer needs, besides nodes/triangles:

* the set of *unique edges* (Morley normal-derivative DOFs live on edges),
* the triangle->edge incidence with a *global edge orientation* so that the
  normal-derivative DOF shared by two triangles has one consistent sign,
* boundary edges with integer labels (label 1 == clamped Dirichlet border,
  the same convention as the reference's .edp templates — symm.edp:26).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TriangleMesh:
    """Static triangle mesh.

    Attributes
    ----------
    nodes : (V, 2) float64
    triangles : (T, 3) int32 — CCW vertex indices.
    node_labels : (V,) int32 — boundary label per node (0 interior/untagged).
    edge_labels : (E,) int32 — label per unique edge (0 for interior).
    """

    nodes: np.ndarray
    triangles: np.ndarray
    node_labels: np.ndarray | None = None
    edge_labels: np.ndarray | None = None

    # filled by __post_init__
    edges: np.ndarray = field(init=False)            # (E, 2) sorted vertex pairs
    tri_edges: np.ndarray = field(init=False)        # (T, 3) edge index opposite local vertex i
    tri_edge_signs: np.ndarray = field(init=False)   # (T, 3) +-1: local outward normal vs global normal
    boundary_edge_mask: np.ndarray = field(init=False)  # (E,) bool

    def __post_init__(self):
        self.nodes = np.ascontiguousarray(self.nodes, dtype=np.float64)
        self.triangles = np.ascontiguousarray(self.triangles, dtype=np.int32)
        self._orient_ccw()
        self._build_edges()
        if self.node_labels is None:
            self.node_labels = np.zeros(self.num_nodes, dtype=np.int32)
        if self.edge_labels is None:
            self.edge_labels = np.zeros(self.num_edges, dtype=np.int32)

    # ------------------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def _orient_ccw(self) -> None:
        p = self.nodes[self.triangles]
        cross = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
            p[:, 1, 1] - p[:, 0, 1]
        ) * (p[:, 2, 0] - p[:, 0, 0])
        flip = cross < 0
        if np.any(flip):
            t = self.triangles[flip]
            self.triangles[flip] = t[:, [0, 2, 1]]

    def _build_edges(self) -> None:
        T = self.triangles
        # edge i is opposite local vertex i: e0=(v1,v2), e1=(v2,v0), e2=(v0,v1)
        raw = np.stack(
            [T[:, [1, 2]], T[:, [2, 0]], T[:, [0, 1]]], axis=1
        )  # (T, 3, 2)
        lo = raw.min(axis=2)
        hi = raw.max(axis=2)
        key = lo.astype(np.int64) * self.num_nodes + hi
        uniq, inverse, counts = np.unique(
            key.ravel(), return_inverse=True, return_counts=True
        )
        self.edges = np.stack(
            [uniq // self.num_nodes, uniq % self.num_nodes], axis=1
        ).astype(np.int32)
        self.tri_edges = inverse.reshape(-1, 3).astype(np.int32)
        self.boundary_edge_mask = counts == 1

        # Global edge tangent: from lower to higher vertex index; global normal
        # is the tangent rotated by -90 deg: n_g = (t_y, -t_x).  The element's
        # outward normal at edge opposite vertex i points away from vertex i.
        a = self.nodes[self.edges[:, 0]]
        b = self.nodes[self.edges[:, 1]]
        t = b - a
        n_g = np.stack([t[:, 1], -t[:, 0]], axis=1)  # unnormalised is fine for sign

        signs = np.zeros((self.num_triangles, 3), dtype=np.int8)
        centroids = self.nodes[self.triangles].mean(axis=1)
        for i in range(3):
            e = self.tri_edges[:, i]
            mid = 0.5 * (self.nodes[self.edges[e, 0]] + self.nodes[self.edges[e, 1]])
            outward = mid - centroids  # points from element interior toward edge
            dot = np.einsum("ij,ij->i", outward, n_g[e])
            signs[:, i] = np.where(dot >= 0, 1, -1)
        self.tri_edge_signs = signs

    # ------------------------------------------------------------------

    def boundary_edges(self) -> np.ndarray:
        return np.nonzero(self.boundary_edge_mask)[0]

    def label_boundary(self, predicate, label: int) -> None:
        """Assign ``label`` to boundary edges whose *both endpoints* satisfy
        ``predicate(x, y) -> bool`` (vectorised over nodes).  Also tags nodes."""
        pts = self.nodes
        ok = predicate(pts[:, 0], pts[:, 1])
        for ei in self.boundary_edges():
            a, b = self.edges[ei]
            if ok[a] and ok[b]:
                self.edge_labels[ei] = label
                self.node_labels[a] = label
                self.node_labels[b] = label

    def plot(self, ax=None, **kwargs):
        """Plot triangles (matplotlib), analog of TriMesh.plot_triangles
        (reference pyFreeFem/TriMesh.py:201-295)."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        ax.triplot(
            self.nodes[:, 0], self.nodes[:, 1], self.triangles,
            **({"color": "k", "lw": 0.4} | kwargs),
        )
        ax.set_aspect("equal")
        return ax

    def to_matplotlib_tri(self):
        from matplotlib.tri import Triangulation

        return Triangulation(self.nodes[:, 0], self.nodes[:, 1], self.triangles)
