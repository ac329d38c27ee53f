"""Global FEM assembly over a static sparsity pattern + Dirichlet reduction.

Produces the same operator inventory as the reference's FreeFEM pipeline:

* symmetric (pure bending) path — 6 stiffness matrices K11..K66 for the
  anisotropic rigidities, rotational-inertia L, mass M, indicator-weighted
  corrections, BC-lift vectors and the test-point interpolation row
  (pyFFInterface.py:50-167);
* unsymmetric (3-field laminate) path — membrane/coupling/bending blocks
  KA/KB/KD for the A_ij, B_ij, D_ij moduli, mass blocks with accelerometer
  corrections, BC lift and the accelerometer-disk readout operators
  (pyFFInterface.py:169-509).

Design differences from the reference (deliberate):

* Dirichlet handling reduces to free DOFs sparsely at init (free/constrained
  split + RHS lift, the same math as pyFFInterface.py:82-118) instead of
  densifying (`todense`, pyFFInterface.py:99 — an O(N^2)-memory cliff) or
  keeping penalized rows (tgv trick).  The reduced system stays *symmetric*,
  which unlocks the modal resolvent solver.
* Matrices are stored as flat nonzero data over one shared (row, col) union
  pattern — the same flattening the reference performs in Problem.__init__
  (Problem.py:241-253, 317-345) — so a parameter combination is a cheap
  weighted sum of flat arrays inside jit.

Known reference quirk NOT replicated: pyFFInterface.py:427-461 assigns the
membrane-bending coupling term eps_1*kappa_6 (-2 u_x w_xy) to B26 instead of
B16.  We use the standard CLT energy pairing B16*(eps1 k6 + eps6 k1),
B26*(eps2 k6 + eps6 k2).  For mid-plane-symmetric materials (B == 0) the two
agree exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.core import TriangleMesh
from ..mesh.locate import locate_points
from .morley import build_morley, morley_point_eval
from .p1 import build_p1

MODULI_INDICES = ["11", "12", "16", "22", "26", "66"]


# ---------------------------------------------------------------------------
# sparsity pattern
# ---------------------------------------------------------------------------

@dataclass
class SparsePattern:
    """Static COO pattern sorted by (row-major) linear index."""

    n: int
    rows: np.ndarray
    cols: np.ndarray

    @property
    def nnz(self) -> int:
        return self.rows.size

    @property
    def key(self) -> np.ndarray:
        # cached: recomputing the 64-bit linear keys costs O(nnz) and the
        # the assembly queries slots() once per assembled matrix
        k = getattr(self, "_key", None)
        if k is None:
            k = self.rows.astype(np.int64) * self.n + self.cols.astype(np.int64)
            self._key = k
        return k

    def slots(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        key = rows.astype(np.int64) * self.n + cols.astype(np.int64)
        pkey = self.key
        idx = np.searchsorted(pkey, key)
        assert np.all(pkey[idx] == key), "entry outside pattern"
        return idx


class _COOAssembly:
    """Accumulates named element matrices as COO entry lists.

    The assembled families share a handful of (row_dofs, col_dofs) block
    structures (all six A-moduli matrices scatter identically, etc.), so
    entry indices are deduplicated per dof-array *pair*: the 64-bit key
    sort, the pattern union and the slot lookup each run once per distinct
    pair (~6) instead of once per matrix (~52) — at 100k DOF this is the
    difference between ~45 s and ~15 s of host assembly."""

    def __init__(self, n: int):
        self.n = n
        self._pairs: list[tuple[np.ndarray, np.ndarray]] = []   # raveled (r, c)
        self._pair_ids: dict[tuple[int, int], int] = {}
        self._pair_refs: list = []        # keep sources alive while id()s cached
        self.entries: dict[str, list[tuple[int, np.ndarray]]] = {}

    def _pair(self, row_dofs: np.ndarray, col_dofs: np.ndarray) -> int:
        pk = (id(row_dofs), id(col_dofs))
        pid = self._pair_ids.get(pk)
        if pid is None:
            T, a = row_dofs.shape
            b = col_dofs.shape[1]
            r = np.broadcast_to(row_dofs[:, :, None], (T, a, b)).ravel()
            c = np.broadcast_to(col_dofs[:, None, :], (T, a, b)).ravel()
            pid = len(self._pairs)
            self._pairs.append((r, c))
            self._pair_refs.append((row_dofs, col_dofs))
            self._pair_ids[pk] = pid
        return pid

    def add(self, name: str, row_dofs: np.ndarray, col_dofs: np.ndarray,
            vals: np.ndarray) -> None:
        """row_dofs (T, a), col_dofs (T, b), vals (T, a, b)."""
        self.entries.setdefault(name, []).append(
            (self._pair(row_dofs, col_dofs), vals.ravel()))

    def finalize(self) -> tuple[SparsePattern, dict[str, np.ndarray]]:
        n = self.n
        # per-pair unique keys, then union of the (much smaller) uniques
        pair_keys = [r.astype(np.int64) * n + c.astype(np.int64)
                     for (r, c) in self._pairs]
        key = np.unique(np.concatenate([np.unique(k) for k in pair_keys]))
        pattern = SparsePattern(
            n, (key // n).astype(np.int32), (key % n).astype(np.int32))
        pattern._key = key
        pair_slots = [np.searchsorted(key, k) for k in pair_keys]
        mats = {}
        for name, lst in self.entries.items():
            data = np.zeros(pattern.nnz, dtype=np.float64)
            for (pid, v) in lst:
                slots = pair_slots[pid]
                # accumulate each entry list into fresh zeros, then add:
                # the JAX package's native helper sums in this order
                acc = np.zeros(pattern.nnz, dtype=np.float64)
                np.add.at(acc, slots, v)
                data += acc
            mats[name] = data
        return pattern, mats


# ---------------------------------------------------------------------------
# Dirichlet reduction (free/constrained split + BC lift)
# ---------------------------------------------------------------------------

def reduce_dirichlet(pattern: SparsePattern, mats: dict[str, np.ndarray],
                     constrained: np.ndarray, g: np.ndarray):
    """Split DOFs into free/constrained and build per-matrix BC lifts.

    Returns (red_pattern, red_mats, lifts, free_idx) where
    ``lifts[name][i] = -sum_c mats[name][i, c] * g[c]`` over constrained c —
    the same lift as pyFFInterface.py:106-118, computed sparsely.
    """
    n = pattern.n
    free_mask = ~constrained
    free_idx = np.nonzero(free_mask)[0]
    new_id = -np.ones(n, dtype=np.int64)
    new_id[free_idx] = np.arange(free_idx.size)

    r, c = pattern.rows, pattern.cols
    ff = free_mask[r] & free_mask[c]
    fc = free_mask[r] & constrained[c]

    red_pattern = SparsePattern(
        free_idx.size,
        new_id[r[ff]].astype(np.int32),
        new_id[c[ff]].astype(np.int32),
    )

    red_mats = {}
    lifts = {}
    # integer gathers: ~2x over boolean masks, and this loop touches
    # 52 x nnz f64 entries at the 100k tier
    ff_idx = np.nonzero(ff)[0]
    fc_idx = np.nonzero(fc)[0]
    lift_rows = new_id[r[fc_idx]]
    g_cols = g[c[fc_idx]]
    for name, data in mats.items():
        red_mats[name] = data[ff_idx]
        lift = np.zeros(free_idx.size, dtype=np.float64)
        np.add.at(lift, lift_rows, -data[fc_idx] * g_cols)
        lifts[name] = lift
    return red_pattern, red_mats, lifts, free_idx


# ---------------------------------------------------------------------------
# indicator
# ---------------------------------------------------------------------------

def accel_indicator(cx: float, cy: float, r: float, eps: float = 1e-8):
    """FreeFEM's indAccel (symm.edp:36): 0.5*(1+sign(r^2+eps-(x-cx)^2-(y-cy)^2))."""

    def ind(xy: np.ndarray) -> np.ndarray:
        d2 = (xy[..., 0] - cx) ** 2 + (xy[..., 1] - cy) ** 2
        return 0.5 * (1.0 + np.sign(r * r + eps - d2))

    return ind


# ---------------------------------------------------------------------------
# element matrices
# ---------------------------------------------------------------------------

def _morley_element_matrices(md: dict, ind=None):
    """Element bending matrices from constant second derivatives.

    Returns dict name -> (T, 6, 6).  Bilinear forms follow
    pyFFInterface.py:52-65 exactly (test index a = rows, trial b = cols).
    """
    d2 = md["d2"]  # (T, 6, 3) [xx, yy, xy]
    area = md["area"]  # (T,)
    xx, yy, xy = d2[..., 0], d2[..., 1], d2[..., 2]

    def outer(pa, pb):
        return area[:, None, None] * np.einsum("ta,tb->tab", pa, pb)

    mats = {
        "K11": outer(xx, xx),
        "K12": outer(xx, yy) + outer(yy, xx),  # dyy(u)dxx(v)+dxx(u)dyy(v)
        "K16": 2.0 * (outer(xx, xy) + outer(xy, xx)),
        "K22": outer(yy, yy),
        "K26": 2.0 * (outer(yy, xy) + outer(xy, yy)),
        "K66": 4.0 * outer(xy, xy),
    }

    w = md["wq"]  # (Q,)
    phi = md["phi_q"]  # (T, Q, 6)
    grad = md["grad_q"]  # (T, Q, 6, 2)
    aw = area[:, None] * w[None, :]  # (T, Q)

    mats["M"] = np.einsum("tq,tqa,tqb->tab", aw, phi, phi)
    mats["L"] = np.einsum("tq,tqad,tqbd->tab", aw, grad, grad)

    if ind is not None:
        iw = aw * ind(md["xq"])
        mats["MCorrection"] = np.einsum("tq,tqa,tqb->tab", iw, phi, phi)
        mats["LCorrection"] = np.einsum("tq,tqad,tqbd->tab", iw, grad, grad)
    return mats


# ---------------------------------------------------------------------------
# symmetric (pure bending) path
# ---------------------------------------------------------------------------

@dataclass
class SymmOperator:
    """Assembled, Dirichlet-reduced bending operator bundle
    (counterpart of the dict returned by load_matrices_symm,
    pyFFInterface.py:150-167, after the flattening in Problem.py:241-253)."""

    pattern: SparsePattern
    Ks: np.ndarray            # (6, nnz) flat stiffness data per modulus
    M: np.ndarray             # (nnz,)
    L: np.ndarray
    MCorrection: np.ndarray
    LCorrection: np.ndarray
    fKs: np.ndarray           # (6, n_free) BC lifts
    fM: np.ndarray
    fL: np.ndarray
    fMCorrection: np.ndarray
    fLCorrection: np.ndarray
    interpolation_vector: np.ndarray        # (n_free,)
    interpolation_value_from_bc: float
    free_idx: np.ndarray
    constrained: np.ndarray   # mask over full DOFs
    boundary_value: np.ndarray  # g over full DOFs
    n_dofs_full: int
    mesh: TriangleMesh = None
    morley: dict = None

    @property
    def n_free(self) -> int:
        return self.free_idx.size


def _w_constraints(mesh: TriangleMesh, labels=(1,)):
    """Constrained Morley DOFs + boundary values for the clamped border(s):
    w = funcBC = 1 at labelled vertices, dw/dn = 0 on labelled edges
    (pyFFInterface.py:24-33: on(1, u=funcBC, ux=0, uy=0) with funcBC = 1).
    ``labels``: border label set to clamp."""
    V, E = mesh.num_nodes, mesh.num_edges
    constrained = np.zeros(V + E, dtype=bool)
    g = np.zeros(V + E, dtype=np.float64)
    labels = np.asarray(labels, dtype=mesh.node_labels.dtype)
    vmask = np.isin(mesh.node_labels, labels)
    emask = np.isin(mesh.edge_labels, labels)
    constrained[:V] = vmask
    constrained[V:] = emask
    g[:V][vmask] = 1.0
    return constrained, g


def assemble_symm(mesh: TriangleMesh, test_point, indicator=None,
                  clamped_labels=(1,)) -> SymmOperator:
    """Assemble the pure-bending (mid-plane symmetric) operator bundle."""
    md = build_morley(mesh)
    n = md["n_dofs"]
    dofs = md["dofs"]

    elem = _morley_element_matrices(md, ind=indicator)
    coo = _COOAssembly(n)
    for name, vals in elem.items():
        coo.add(name, dofs, dofs, vals)
    pattern, mats = coo.finalize()
    if indicator is None:
        mats["MCorrection"] = np.zeros(pattern.nnz)
        mats["LCorrection"] = np.zeros(pattern.nnz)

    constrained, g = _w_constraints(mesh, clamped_labels)
    red_pattern, red_mats, lifts, free_idx = reduce_dirichlet(
        pattern, mats, constrained, g
    )

    # test-point interpolation row (pyFFInterface.py:36-46, 141-146)
    tp = np.atleast_2d(np.asarray(test_point, dtype=np.float64))
    tri_idx, _ = locate_points(mesh, tp)
    vals, _ = morley_point_eval(md, tri_idx, tp)
    full_row = np.zeros(n)
    np.add.at(full_row, dofs[tri_idx[0]], vals[0])
    interp_bc = float(full_row[constrained] @ g[constrained])
    interp_free = full_row[free_idx]

    return SymmOperator(
        pattern=red_pattern,
        Ks=np.stack([red_mats["K" + s] for s in MODULI_INDICES]),
        M=red_mats["M"],
        L=red_mats["L"],
        MCorrection=red_mats["MCorrection"],
        LCorrection=red_mats["LCorrection"],
        fKs=np.stack([lifts["K" + s] for s in MODULI_INDICES]),
        fM=lifts["M"],
        fL=lifts["L"],
        fMCorrection=lifts["MCorrection"],
        fLCorrection=lifts["LCorrection"],
        interpolation_vector=interp_free,
        interpolation_value_from_bc=interp_bc,
        free_idx=free_idx,
        constrained=constrained,
        boundary_value=g,
        n_dofs_full=n,
        mesh=mesh,
        morley=md,
    )


# ---------------------------------------------------------------------------
# unsymmetric (3-field laminate) path
# ---------------------------------------------------------------------------

@dataclass
class UnsymmOperator:
    """Assembled, reduced 3-field operator bundle (counterpart of the
    26-matrix list from load_matrices_unsymm, pyFFInterface.py:503-509).

    ``mats``/``lifts`` keys: A11..A66, B11..B66, D11..D66 (per-modulus
    stiffness blocks) and M11, M11C, M22, M22C, M33, M33C, M33I2, M33I2C
    (mass blocks; C = indicator-weighted accelerometer correction)."""

    pattern: SparsePattern
    mats: dict
    lifts: dict
    readout: dict             # name -> (R (P, n_free), r0 (P,)) for u,v,w,wx,wy
    free_idx: np.ndarray
    constrained: np.ndarray
    boundary_value: np.ndarray
    n_dofs_full: int
    Lh_size: int
    Mh_size: int
    mesh: TriangleMesh = None
    morley: dict = None

    @property
    def n_free(self) -> int:
        return self.free_idx.size

    def mat_stack(self, names) -> np.ndarray:
        return np.stack([self.mats[k] for k in names])

    def lift_stack(self, names) -> np.ndarray:
        return np.stack([self.lifts[k] for k in names])


def disk_sample_points(cx: float, cy: float, r: float, n_boundary: int = 64,
                       inner_mult: float = 0.3) -> np.ndarray:
    """Sample points of the accelerometer readout disk.

    The reference builds a tiny FreeFEM mesh of the disk of radius
    0.3*rAccel and averages FE values over its P1 nodes
    (pyFFInterface.py:199-212, Problem.py:454-462).  We use the same
    boundary discretisation (64-point circle) plus a sunflower interior fill
    of matching density; the mean over either point cloud approximates the
    same disk average.
    """
    rr = inner_mult * r
    t = 2 * np.pi * np.arange(n_boundary) / n_boundary
    boundary = np.stack([cx + rr * np.cos(t), cy + rr * np.sin(t)], axis=1)

    spacing = 2 * np.pi * rr / n_boundary
    n_inner = max(int(np.pi * rr * rr / (spacing * spacing * np.sqrt(3) / 2)), 1)
    k = np.arange(1, n_inner + 1)
    rad = rr * np.sqrt((k - 0.5) / n_inner) * (1 - spacing / (2 * rr))
    ang = k * np.pi * (3 - np.sqrt(5.0))  # golden angle
    inner = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
    return np.concatenate([boundary, inner], axis=0)


def _uvw_constraints(mesh: TriangleMesh, labels=(1,)):
    """Constrained 3-field DOFs: u = v = 0 and w = funcBC = 1, wn = 0 on the
    labelled border(s) (pyFFInterface.py:187-197)."""
    V, E = mesh.num_nodes, mesh.num_edges
    n = 2 * V + V + E
    constrained = np.zeros(n, dtype=bool)
    g = np.zeros(n, dtype=np.float64)
    labels = np.asarray(labels, dtype=mesh.node_labels.dtype)
    vmask = np.isin(mesh.node_labels, labels)
    emask = np.isin(mesh.edge_labels, labels)
    constrained[:V] = vmask                       # u
    constrained[V : 2 * V] = vmask                # v
    constrained[2 * V : 3 * V] = vmask            # w vertex DOFs
    constrained[3 * V :] = emask                  # w edge-normal DOFs
    g[2 * V : 3 * V][vmask] = 1.0
    return constrained, g


def assemble_unsymm(mesh: TriangleMesh, accel_center, accel_r,
                    indicator=None, clamped_labels=(1,)) -> UnsymmOperator:
    """Assemble the membrane+bending 3-field operator bundle."""
    md = build_morley(mesh)
    pd = build_p1(mesh)

    V, E = mesh.num_nodes, mesh.num_edges
    Lh = V
    Mh = V + E
    n = 2 * Lh + Mh

    du = pd["dofs"]                 # u rows/cols
    dv = pd["dofs"] + Lh            # v
    dw = md["dofs"] + 2 * Lh        # w

    area = pd["area"]
    gP = pd["grad"]                 # (T, 3, 2)
    gx, gy = gP[..., 0], gP[..., 1]
    d2 = md["d2"]
    wxx, wyy, wxy = d2[..., 0], d2[..., 1], d2[..., 2]

    def pp(a_, b_):
        """(T,3,3) area-weighted outer product of constant P1 derivative rows."""
        return area[:, None, None] * np.einsum("ta,tb->tab", a_, b_)

    def pm(a_, b_):
        """(T,3,6) P1-row x Morley-col coupling."""
        return area[:, None, None] * np.einsum("ta,tb->tab", a_, b_)

    coo = _COOAssembly(n)

    # ---- membrane blocks (energy eps^T A eps; eps = [u_x, v_y, u_y+v_x]) ----
    coo.add("A11", du, du, pp(gx, gx))
    coo.add("A12", du, dv, pp(gx, gy))
    coo.add("A12", dv, du, pp(gy, gx))
    coo.add("A16", du, du, pp(gy, gx) + pp(gx, gy))
    coo.add("A16", du, dv, pp(gx, gx))
    coo.add("A16", dv, du, pp(gx, gx))
    coo.add("A22", dv, dv, pp(gy, gy))
    coo.add("A26", du, dv, pp(gy, gy))
    coo.add("A26", dv, du, pp(gy, gy))
    coo.add("A26", dv, dv, pp(gx, gy) + pp(gy, gx))
    coo.add("A66", du, du, pp(gy, gy))
    coo.add("A66", dv, dv, pp(gx, gx))
    coo.add("A66", du, dv, pp(gy, gx))
    coo.add("A66", dv, du, pp(gx, gy))

    # ---- coupling blocks (eps(test)^T B kappa(trial) + transpose);
    #      kappa = [-w_xx, -w_yy, -2 w_xy] ------------------------------------
    def add_B(name, p_rows, p_deriv, w_curv, scale=1.0):
        """Add scale * int p_deriv(test) * w_curv(trial) into (p_rows, w) block
        and its transpose."""
        block = scale * pm(p_deriv, w_curv)
        coo.add(name, p_rows, dw, block)
        coo.add(name, dw, p_rows, np.transpose(block, (0, 2, 1)))

    add_B("B11", du, gx, wxx, -1.0)                     # eps1*k1
    add_B("B12", du, gx, wyy, -1.0)                     # eps1*k2
    add_B("B12", dv, gy, wxx, -1.0)                     # eps2*k1
    add_B("B16", du, gx, wxy, -2.0)                     # eps1*k6
    add_B("B16", du, gy, wxx, -1.0)                     # eps6*k1 (u part)
    add_B("B16", dv, gx, wxx, -1.0)                     # eps6*k1 (v part)
    add_B("B22", dv, gy, wyy, -1.0)                     # eps2*k2
    add_B("B26", dv, gy, wxy, -2.0)                     # eps2*k6
    add_B("B26", du, gy, wyy, -1.0)                     # eps6*k2 (u part)
    add_B("B26", dv, gx, wyy, -1.0)                     # eps6*k2 (v part)
    add_B("B66", du, gy, wxy, -2.0)                     # eps6*k6 (u part)
    add_B("B66", dv, gx, wxy, -2.0)                     # eps6*k6 (v part)

    # ---- bending blocks (same forms as the symmetric path) ------------------
    bend = _morley_element_matrices(md, ind=indicator)
    for s in MODULI_INDICES:
        coo.add("D" + s, dw, dw, bend["K" + s])

    # ---- mass blocks ---------------------------------------------------------
    w = pd["wq"]
    aw = area[:, None] * w[None, :]
    phiP = pd["phi_q"]
    m_p1 = np.einsum("tq,tqa,tqb->tab", aw, phiP, phiP)
    coo.add("M11", du, du, m_p1)
    coo.add("M22", dv, dv, m_p1)
    coo.add("M33", dw, dw, bend["M"])
    coo.add("M33I2", dw, dw, bend["L"])

    if indicator is not None:
        iw = aw * indicator(pd["xq"])
        m_p1c = np.einsum("tq,tqa,tqb->tab", iw, phiP, phiP)
        coo.add("M11C", du, du, m_p1c)
        coo.add("M22C", dv, dv, m_p1c)
        coo.add("M33C", dw, dw, bend["MCorrection"])
        coo.add("M33I2C", dw, dw, bend["LCorrection"])

    pattern, mats = coo.finalize()
    for name in ("M11C", "M22C", "M33C", "M33I2C"):
        if name not in mats:
            mats[name] = np.zeros(pattern.nnz)

    constrained, g = _uvw_constraints(mesh, clamped_labels)
    red_pattern, red_mats, lifts, free_idx = reduce_dirichlet(
        pattern, mats, constrained, g
    )

    # ---- accelerometer-disk readout operators --------------------------------
    pts = disk_sample_points(accel_center[0], accel_center[1], accel_r)
    tri_idx, bary = locate_points(mesh, pts)
    P = pts.shape[0]

    w_vals, w_grads = morley_point_eval(md, tri_idx, pts)
    new_id = -np.ones(n, dtype=np.int64)
    new_id[free_idx] = np.arange(free_idx.size)

    def make_readout(local_dofs, local_vals):
        """Static (R, r0): point values = R @ u_free + r0."""
        R = np.zeros((P, free_idx.size))
        r0 = np.zeros(P)
        for p in range(P):
            for a in range(local_dofs.shape[1]):
                dof = local_dofs[p, a]
                if constrained[dof]:
                    r0[p] += local_vals[p, a] * g[dof]
                else:
                    R[p, new_id[dof]] += local_vals[p, a]
        return R, r0

    dof_w = dw[tri_idx]
    dof_u = du[tri_idx]
    dof_v = dv[tri_idx]
    readout = {
        "u": make_readout(dof_u, bary),
        "v": make_readout(dof_v, bary),
        "w": make_readout(dof_w, w_vals),
        "wx": make_readout(dof_w, w_grads[..., 0]),
        "wy": make_readout(dof_w, w_grads[..., 1]),
    }

    return UnsymmOperator(
        pattern=red_pattern,
        mats=red_mats,
        lifts=lifts,
        readout=readout,
        free_idx=free_idx,
        constrained=constrained,
        boundary_value=g,
        n_dofs_full=n,
        Lh_size=Lh,
        Mh_size=Mh,
        mesh=mesh,
        morley=md,
    )
