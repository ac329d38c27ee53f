"""Multilevel (geometric) preconditioners (port of ``ops/mg.py``).

    C(r) = S(r) + P C_coarse(P^T (r - K S(r))) ,  S = Chebyshev smoothing

with *geometric* prolongations P evaluated through the FE bases (P1 for the
membrane fields, Morley values/normal-derivatives for bending), Galerkin
coarse operators (P^T K P, host scipy) and a dense inverse of the coarsest
one.  The cycles run in f32: they are only preconditioners, and the FGMRES
around them (ops/mixed.py) computes its residuals in exact split-complex
f64, so their roundoff costs iterations, never accuracy.

Two cycles, both the JAX package's:

* ``twogrid_apply``, the band tier's: the fine operator in the RCM
  block-tridiagonal layout, applied by the CUDA band kernel (K1,
  ops/band_kernel.py), one coarse level through the rectangular
  block-band prolongation; on a rank of a dof mesh ``twogrid_apply_rows``
  runs the same cycle on the rank's block rows (``TwoGridRows``) with the
  whole cycle's bits;
* ``multilevel_apply``, the flat layout's: a recursive (V- or W-) cycle
  over any number of levels, every product on a flat pattern through the
  CSR kernel (K3, ops/csr_kernel.py) — the level operators, and the
  prolongations P and restrictions P^T as rectangular patterns, each with
  its plan (``multilevel_to_device``); the optional level-0 band operator
  runs K1.

The host-side code (``build_prolongation``, ``build_multilevel_host``) is a
numpy copy of the JAX package's; the device half is torch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from .band import (fold_windows, rect_band_mv, rect_band_mv_rows,
                   rect_band_tmv, restrict_windows)
from .band_kernel import BandTiles, band_mv_f32
from .dense import dense_apply


def build_prolongation(fine_mesh, coarse_mesh, fine_free_idx, coarse_free_idx,
                       fine_constrained, coarse_constrained,
                       three_field: bool):
    """Sparse prolongation (fine free DOFs) x (coarse free DOFs).

    DOF layouts follow fem.assembly: Morley w = [vertex values, V + edge
    normal derivatives]; 3-field = [u (V), v (V), w (V+E)].
    Each fine DOF is the corresponding linear functional applied to the
    coarse FE interpolant.
    """
    import scipy.sparse as sp

    from ..fem.morley import build_morley, morley_point_eval
    from ..mesh.locate import locate_points

    mdc = build_morley(coarse_mesh)
    Vf, Ef = fine_mesh.num_nodes, fine_mesh.num_edges
    Vc, Ec = coarse_mesh.num_nodes, coarse_mesh.num_edges
    nf_full = (2 * Vf + Vf + Ef) if three_field else (Vf + Ef)
    nc_full = (2 * Vc + Vc + Ec) if three_field else (Vc + Ec)
    w_off_f = 2 * Vf if three_field else 0
    w_off_c = 2 * Vc if three_field else 0

    # all blocks assembled with bulk numpy (a Python per-DOF loop here cost
    # ~10 minutes of the 100k-tier host prep)
    rows_l, cols_l, vals_l = [], [], []
    dofs_c_w = mdc["dofs"]  # (Tc, 6) in w-local numbering

    # ---- w vertex DOFs: coarse Morley value at fine nodes -----------------
    tri_v, _ = locate_points(coarse_mesh, fine_mesh.nodes)
    phi_v, _ = morley_point_eval(mdc, tri_v, fine_mesh.nodes)
    rows_l.append(np.repeat(w_off_f + np.arange(Vf), 6))
    cols_l.append((w_off_c + dofs_c_w[tri_v]).ravel())
    vals_l.append(phi_v.ravel())

    # ---- w edge DOFs: coarse Morley normal derivative at fine edge mids ---
    ea = fine_mesh.nodes[fine_mesh.edges[:, 0]]
    eb = fine_mesh.nodes[fine_mesh.edges[:, 1]]
    mids = 0.5 * (ea + eb)
    t = eb - ea
    nrm = np.stack([t[:, 1], -t[:, 0]], axis=1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tri_e, _ = locate_points(coarse_mesh, mids)
    _, grads_e = morley_point_eval(mdc, tri_e, mids)
    dn = np.einsum("pjd,pd->pj", grads_e, nrm)  # (Ef, 6)
    rows_l.append(np.repeat(w_off_f + Vf + np.arange(Ef), 6))
    cols_l.append((w_off_c + dofs_c_w[tri_e]).ravel())
    vals_l.append(dn.ravel())

    # ---- membrane u, v: coarse P1 at fine nodes ----------------------------
    if three_field:
        tri_p, bary_p = locate_points(coarse_mesh, fine_mesh.nodes)
        c_verts = coarse_mesh.triangles[tri_p]               # (Vf, 3)
        rows_l.append(np.repeat(np.arange(Vf), 3))           # u block
        cols_l.append(c_verts.ravel())
        vals_l.append(bary_p.ravel())
        rows_l.append(np.repeat(Vf + np.arange(Vf), 3))      # v block
        cols_l.append((Vc + c_verts).ravel())
        vals_l.append(bary_p.ravel())

    P_full = sp.csr_matrix(
        (np.concatenate(vals_l),
         (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(nf_full, nc_full),
    )
    return P_full[fine_free_idx][:, coarse_free_idx].tocsr()


def _dinv_lmax(K):
    """Inverse diagonal and a GUARANTEED upper bound on lambda_max(D^-1 K).

    The bound must not under-estimate: Chebyshev smoothing DIVERGES on any
    mode above its interval, and a 30-step power iteration under-estimated
    lambda_max enough at n ~ 20k that the whole multigrid cycle amplified
    2-3x per application (measured).  Gershgorin over rows of D^-1 K is
    cheap and safe; the <= 2x looseness only mildly softens the smoother."""
    import scipy.sparse as sp

    d = np.asarray(K.diagonal())
    d = np.where(np.abs(d) > 0, d, 1.0)
    dinv = 1.0 / d
    absK = abs(sp.csr_matrix(K))
    row_sums = np.asarray(absK.sum(axis=1)).ravel()
    lmax = float((np.abs(dinv) * row_sums).max())
    return dinv, lmax


def _pin_dead(Kc, P_csr):
    """Pin coarse DOFs whose P column is empty (e.g. a sliver coarse
    triangle near a curved hole that contains no fine sample point) — they
    receive zero restricted residual and feed nothing back through P, so a
    unit diagonal is exact and keeps Kc nonsingular."""
    import scipy.sparse as sp

    dead = np.asarray(P_csr.multiply(P_csr).sum(axis=0)).ravel() == 0.0
    if dead.any():
        keep = sp.diags((~dead).astype(Kc.dtype))
        Kc = keep @ Kc @ keep + sp.diags(dead.astype(Kc.dtype))
    return Kc


def build_multilevel_host(K_flat, rows, cols, n: int, P_csr_list,
                          row_scale=None, invert_coarse: bool = True):
    """Host-side data for the multilevel V-cycle on an equilibrated SPD K.

    ``P_csr_list``: geometric prolongations finest-first — entry ``l`` maps
    level ``l+1`` DOFs to level ``l`` DOFs (level 0 = the fine operator).
    ``row_scale``: the fine-grid equilibration vector s (K here is
    S K_phys S).  The prolongations are built in PHYSICAL DOF space, so the
    finest one must be mapped into scaled variables, P~ = S^-1 P — without
    this the coarse correction cannot represent the scaled smooth error and
    the cycle stalls near rate ~0.95; with it the JAX package measured a
    rate of ~0.29 (its tests/test_mg.py).  Coarser levels keep physical
    variables throughout (the Chebyshev smoother normalizes through D^-1,
    so no per-level re-equilibration is needed).

    Returns ``(arrays, static)``: ``arrays`` holds numpy arrays (per-level
    inverse diagonals, flat coarse operators, flat prolongations, and the
    coarsest level: its dense inverse ``Kc_inv32``, or with
    ``invert_coarse=False`` its flat operator ``Kc_coo`` for the caller to
    invert on its device); ``static`` the per-level lambda_max bounds and
    DOF counts.  Everything is f32 as in the JAX package — the cycle is a
    preconditioner — except ``Kc_coo``'s data, which stays f64 here: the
    port inverts the coarsest operator in f64 (ops/dense.py), and the
    Galerkin operator's spread (~1e7) would turn the f32 rounding of its
    entries into an O(1) error of that inverse.
    """
    import scipy.sparse as sp

    K = sp.csc_matrix((K_flat, (rows, cols)), shape=(n, n))
    K = 0.5 * (K + K.T)

    levels = []
    lmaxs = []
    ns = [n]
    for li, P in enumerate(P_csr_list):
        if li == 0 and row_scale is not None:
            P = (sp.diags(1.0 / np.asarray(row_scale)) @ P).tocsr()
        dinv, lmax = _dinv_lmax(K)
        lv = {"dinv": dinv.astype(np.float32)}
        if li > 0:
            Kcoo = K.tocoo()
            lv |= {
                "Kf": Kcoo.data.astype(np.float32),
                "rows": Kcoo.row.astype(np.int32),
                "cols": Kcoo.col.astype(np.int32),
            }
        Pcoo = P.tocoo()
        lv |= {
            "P_rows": Pcoo.row.astype(np.int32),
            "P_cols": Pcoo.col.astype(np.int32),
            "P_vals": Pcoo.data.astype(np.float32),
        }
        levels.append(lv)
        lmaxs.append(lmax)
        ns.append(P.shape[1])

        K = _pin_dead((P.T @ (K @ P)).tocsc(), P)
        K = 0.5 * (K + K.T)

    arrays = {"levels": tuple(levels)}
    if invert_coarse:
        # sparse LU + identity solves: no O(n^3) dense work and no f64
        # dense copy of K on the host
        import scipy.sparse.linalg as spla

        lu = spla.splu(K.tocsc())
        Kc_inv = lu.solve(np.eye(K.shape[0]))
        arrays["Kc_inv32"] = np.ascontiguousarray(Kc_inv.astype(np.float32))
    else:
        Kcoo = K.tocoo()
        arrays["Kc_coo"] = {"data": Kcoo.data.astype(np.float64),
                            "rows": Kcoo.row.astype(np.int32),
                            "cols": Kcoo.col.astype(np.int32),
                            "n": K.shape[0]}
    static = {"lmax": tuple(lmaxs), "n": tuple(ns)}
    return arrays, static


def _chebyshev_smooth(mg, K_mv, r, e0=None, steps: int = 4,
                      spectrum_fraction: float = 8.0):
    """Chebyshev polynomial smoothing on the interval
    [lmax/spectrum_fraction, lmax] of D^-1 K (the standard AMG smoother —
    targets the high-frequency error the coarse grid cannot see)."""
    dinv = mg["dinv"]
    lmax = mg["lmax"]
    lmin = lmax / spectrum_fraction
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

    e = torch.zeros_like(r) if e0 is None else e0
    res = r if e0 is None else r - K_mv(e)
    p = dinv * res / theta
    for _ in range(steps - 1):
        e = e + p
        res = res - K_mv(p)
        rho_new = 1.0 / (2.0 * sigma - rho)
        p = rho_new * rho * p + (2.0 * rho_new / delta) * (dinv * res)
        rho = rho_new
    return e + p


def twogrid_apply(pack, dinv, lmax, Pt, Kc_inv, r32, layout, rl,
                  slots, smooth_steps: int = 4):
    """Symmetric two-grid cycle on (..., n) f32 residuals: Chebyshev
    pre-smooth on the f32 band operator (``pack``: its nonzero tiles,
    ops/band_kernel.pack_band_tiles), exact coarse correction through
    the rectangular block-band prolongation and the dense coarse inverse
    (one GEMM in the inverse's dtype: f64 as ``Problem`` builds it, f32
    from the JAX package's operator data, IEEE with TF32 off, see
    config.py; the correction goes back in f32), Chebyshev post-smooth."""

    def K_mv(x):
        return band_mv_f32(pack, x, layout)

    sm = {"dinv": dinv, "lmax": lmax}
    e = _chebyshev_smooth(sm, K_mv, r32, steps=smooth_steps)
    res = r32 - K_mv(e)
    rc = rect_band_tmv(Pt, res, rl, slots)
    ec = dense_apply(Kc_inv, rc).to(rc.dtype)
    e = e + rect_band_mv(Pt, ec, rl, slots)
    return _chebyshev_smooth(sm, K_mv, r32, e0=e, steps=smooth_steps)


@dataclass(frozen=True)
class TwoGridRows:
    """Block rows [q0, q1) of the two-grid's band that one rank of a dof
    group owns, and what the cycle reads on them: ``band`` (q1 - q0, b,
    3b) its rows of ``mg_band0``, ``pack`` their window pack (K1's,
    ops/band_kernel.py), ``Pt`` (q1 - q0, b, nd*bc) its rows of ``mg_Pt``,
    ``dinv`` its rows [q0 b, min(n, q1 b)) of ``mg_dinv``.  ``bounds``: the
    block-row bounds of every rank of the group (whole groups of
    ``dense.fixed_blocks(nb, 1)``), ``rank`` this one's place.  ``stack``
    (``bind``) is the dof group's gather: (ranks, *part.shape), every
    rank's part in its slot, the same bits on every rank; unbound, a
    rank alone cannot run the cycle and ``unbound()`` is raised.

    Every product keeps the whole cycle's bits: K1 walks a row's tiles as
    in the whole pack, the prolongation's and restriction's GEMMs are the
    whole ones' calls on the rank's groups, the restriction folds every
    coarse slot's terms in the whole order (the neighbours' terms next to
    a bound come in by one exchange), and every combine is a gather."""

    band: torch.Tensor
    pack: BandTiles
    Pt: torch.Tensor
    dinv: torch.Tensor
    bounds: tuple
    rank: int
    unbound: Callable
    stack: Callable | None = None

    ndim = 3

    @property
    def q0(self) -> int:
        return self.bounds[self.rank]

    @property
    def q1(self) -> int:
        return self.bounds[self.rank + 1]

    @property
    def rows(self) -> tuple[int, int]:
        return self.pack.rows

    @property
    def shape(self) -> tuple:
        """The whole band's."""
        return (self.bounds[-1],) + tuple(self.band.shape[1:])

    def bind(self, stack: Callable) -> "TwoGridRows":
        """The same rows, their combines through ``stack``."""
        return replace(self, stack=stack)

    def _gather(self, part):
        if self.stack is None:
            raise self.unbound()
        return self.stack(part)

    def _concat(self, v, sizes):
        """(B, sum sizes): every rank's (B, sizes[rank]) ``v`` joined in
        rank order (one gather, each part sent padded to max sizes)."""
        buf = v.new_zeros((v.shape[0], max(sizes)))
        buf[:, :v.shape[1]] = v
        stack = self._gather(buf)
        return torch.cat([stack[j, :, :k] for j, k in enumerate(sizes)], 1)

    def own(self, x):
        """This rank's rows of a whole (..., n) vector."""
        lo, hi = self.rows
        return x[..., lo:hi]

    def whole(self, v):
        """The whole (..., n) vector of every rank's rows ``v`` (...,
        rows) (one gather)."""
        b, n, qs = self.band.shape[1], self.pack.n, self.bounds
        sizes = [min(n, qs[j + 1] * b) - qs[j] * b
                 for j in range(len(qs) - 1)]
        return self._concat(v.reshape(-1, v.shape[-1]), sizes).reshape(
            v.shape[:-1] + (n,))

    def halo(self, v):
        """(B, nx): the x window of this rank's pack, its rows ``v`` (...,
        rows) with the neighbours' boundary block rows on each side (one
        exchange: every rank's first and last block row)."""
        b = self.band.shape[1]
        lo, hi = self.rows
        xlo, xhi = self.pack.cols
        vf = v.reshape(-1, hi - lo)
        ends = vf.new_zeros((2, vf.shape[0], b))
        head, tail = vf[:, :b], vf[:, -b:]
        ends[0, :, :head.shape[1]] = head
        ends[1, :, b - tail.shape[1]:] = tail
        stack = self._gather(ends)
        parts = [vf]
        if xlo < lo:
            parts.insert(0, stack[self.rank - 1, 1, :, b - (lo - xlo):])
        if xhi > hi:
            parts.append(stack[self.rank + 1, 0, :, :xhi - hi])
        return torch.cat(parts, 1)

    def mv(self, v, layout):
        """This rank's rows of K v for its rows ``v`` (..., rows): one halo
        exchange, one K1 launch on the window."""
        return band_mv_f32(self.pack, self.halo(v), layout).reshape(v.shape)

    def mv_whole(self, y, layout):
        """This rank's rows of K y for a whole (..., n) ``y``: one K1 launch
        on the window, no exchange."""
        xlo, xhi = self.pack.cols
        return band_mv_f32(self.pack, y[..., xlo:xhi].contiguous(), layout)

    def restrict(self, res, rl, slots):
        """The whole coarse residual P^T r (..., n_c) from this rank's rows
        of r: its window terms, the terms of the block rows within hw of
        its bounds from the ranks that own them (one exchange: every
        rank's first and last hw block rows), the fold of its coarse
        blocks in the whole restriction's d order, and every rank's folded
        blocks (one gather)."""
        hw, nb, qs = rl.hw, rl.nb, self.bounds
        w = restrict_windows(self.Pt, res, rl, self.q0)  # (B, nq, nd, bc)
        B, nq = w.shape[:2]
        k = min(hw, nq)
        ends = w.new_zeros((2, B, hw, rl.nd, rl.bc))
        if k:
            ends[0, :, :k] = w[:, :k]
            ends[1, :, hw - k:] = w[:, nq - k:]
        stack = self._gather(ends)

        def term(q):
            # block row q, within hw of its owner j's bounds: in j's last
            # hw left of q0, in its first hw right of q1
            j = max(i for i in range(len(qs) - 1) if qs[i] <= q)
            return (stack[j, 1, :, hw - (qs[j + 1] - q)] if q < self.q0
                    else stack[j, 0, :, q - qs[j]])

        e0, e1 = max(0, self.q0 - hw), min(nb, self.q1 + hw)
        w_ext = torch.cat([term(q)[:, None] for q in range(e0, self.q0)]
                          + [w] + [term(q)[:, None]
                                   for q in range(self.q1, e1)], 1)
        acc = fold_windows(w_ext, e0, self.q0, self.q1, rl)
        sizes = [(qs[j + 1] - qs[j]) * rl.bc for j in range(len(qs) - 1)]
        full = self._concat(acc.reshape(B, -1), sizes)
        return full[:, slots].reshape(res.shape[:-1] + (rl.n_coarse,))

    def prolong(self, ec, rl, slots):
        """This rank's rows of P ec for the whole coarse ``ec`` (...,
        n_c): no exchange."""
        return rect_band_mv_rows(self.Pt, ec, rl, slots, self.q0)


def twogrid_apply_rows(part: TwoGridRows, lmax, Kc_inv, r_rows, layout, rl,
                       slots, smooth_steps: int = 4):
    """``twogrid_apply`` on a rank of a dof group (``part``, bound): this
    rank's rows of the (..., n) f32 residual in, the whole cycle output
    out, the whole cycle's bits.  The Chebyshev vectors stay on the rank's
    rows (a halo exchange before each K1 apply); the coarse residual is
    gathered whole, so the dof group's row blocks of the coarse inverse
    (``Kc_inv``, a ``RowShard``) apply to it as to the whole one; one
    gather at the end."""

    def K_mv(x):
        return part.mv(x, layout)

    sm = {"dinv": part.dinv, "lmax": lmax}
    e = _chebyshev_smooth(sm, K_mv, r_rows, steps=smooth_steps)
    res = r_rows - K_mv(e)
    rc = part.restrict(res, rl, slots)
    ec = dense_apply(Kc_inv, rc).to(rc.dtype)
    e = e + part.prolong(ec, rl, slots)
    return part.whole(_chebyshev_smooth(sm, K_mv, r_rows, e0=e,
                                        steps=smooth_steps))


def multilevel_to_device(arrays, static, device, Kc_inv=None) -> dict:
    """The host hierarchy of ``build_multilevel_host`` on ``device``, as
    ``multilevel_apply`` reads it, built once: per level its inverse
    diagonal, its f32 operator with its CSR plan (levels >= 1; level 0 is
    the caller's fine operator), and its prolongation's f32 values with two
    plans on them, P (n_l x n_{l+1}) and P^T (n_{l+1} x n_l, the swapped
    pattern, reading the same values); the coarsest dense inverse in f32
    (``Kc_inv``, any dtype on any device, else ``arrays["Kc_inv32"]``)."""
    from .csr_kernel import build_csr

    ns = tuple(int(v) for v in static["n"])

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    levels = []
    for l, lv in enumerate(arrays["levels"]):
        d = {"dinv": f32(lv["dinv"]), "P": f32(lv["P_vals"])[None],
             "P_csr": build_csr(idx(lv["P_rows"]), idx(lv["P_cols"]), ns[l],
                                ns[l + 1]),
             "Pt_csr": build_csr(idx(lv["P_cols"]), idx(lv["P_rows"]),
                                 ns[l + 1], ns[l])}
        if l > 0:
            d |= {"K": f32(lv["Kf"])[None],
                  "csr": build_csr(idx(lv["rows"]), idx(lv["cols"]), ns[l])}
        levels.append(d)
    inv = arrays["Kc_inv32"] if Kc_inv is None else Kc_inv
    return {"levels": levels,
            "Kc_inv32": torch.as_tensor(inv, device=device).to(torch.float32),
            "lmax": tuple(float(v) for v in static["lmax"]), "n": ns}


def multilevel_apply(mg: dict, K0, csr0, r, smooth_steps: int = 4,
                     w_cycle: bool | None = None, band0=None, layout=None):
    """One symmetric multigrid cycle on (..., n) residuals (JAX
    ``multilevel_apply``): Chebyshev pre-smooth, recursive coarse
    correction, Chebyshev post-smooth at every level, the coarsest level
    one GEMM with the dense inverse.  ``mg``: ``multilevel_to_device``'s
    hierarchy; ``K0`` (nnz,) the fine operator's data on the plan ``csr0``
    (cast to f32 once here; pass f32 to skip the cast).  Compute is f32
    throughout; returns the correction in ``r``'s dtype.

    ``w_cycle=True`` applies TWO recursive corrections per coarse visit (a
    W-cycle): on the 2D plate hierarchy the coarse work shrinks ~4x per
    level, so the extra visits cost ~25% while holding the multilevel rate
    near the two-grid rate (the JAX package measured 0.49 V vs ~0.3 W at
    three levels); None: a W-cycle where there are two or more smoothed
    levels (with one, the coarse solve is the exact dense inverse and a
    second visit would re-solve the same system).

    ``band0``/``layout``: the f32 fine operator packed for the band kernel
    (``pack_band_tiles``) in its RCM block-tridiagonal layout, which then
    replaces the level-0 K3 product; the caller's pattern and residuals
    must already live in the layout's RCM ordering.
    """
    # looked up at each call: chip_smoke.py's RectCount wraps it to count
    # the launches on the rectangular plans
    from .csr_kernel import csr_mv

    levels = mg["levels"]
    in_dtype = r.dtype
    K032 = K0.to(torch.float32).reshape(1, -1)
    if w_cycle is None:
        w_cycle = len(levels) >= 2

    def level_mv(l):
        if l == 0:
            if band0 is not None:
                return lambda x: band_mv_f32(band0, x, layout)
            return lambda x: csr_mv(K032, x, csr0)[0]
        lv = levels[l]
        return lambda x: csr_mv(lv["K"], x, lv["csr"])[0]

    def coarse_correct(l, rc):
        """Approximately solve K_l e = rc by one (or two) recursive
        cycles; level len(levels) is the exact dense inverse."""
        ec = cycle(l, rc)
        if w_cycle and l < len(levels):
            ec = ec + cycle(l, rc - level_mv(l)(ec))
        return ec

    def cycle(l, rl):
        if l == len(levels):
            return rl @ mg["Kc_inv32"].T
        lv = levels[l]
        K_mv = level_mv(l)
        sm = {"dinv": lv["dinv"], "lmax": mg["lmax"][l]}
        e = _chebyshev_smooth(sm, K_mv, rl, steps=smooth_steps)
        res = rl - K_mv(e)
        rc = csr_mv(lv["P"], res, lv["Pt_csr"])[0]          # P^T res
        e = e + csr_mv(lv["P"], coarse_correct(l + 1, rc), lv["P_csr"])[0]
        return _chebyshev_smooth(sm, K_mv, rl, e0=e, steps=smooth_steps)

    return cycle(0, r.to(torch.float32)).to(in_dtype)
