"""Two-grid preconditioner of the band tier (port of ``ops/mg.py``).

    C(r) = S(r) + P Kc^-1 P^T (r - K S(r)) ,  S = Chebyshev smoothing

with *geometric* prolongations P evaluated through the FE bases (P1 for the
membrane fields, Morley values/normal-derivatives for bending), a Galerkin
coarse operator (host scipy) and its dense f32 inverse.  The cycle runs in
f32: it is only a preconditioner, and the FGMRES around it (ops/mixed.py)
computes its residuals in exact split-complex f64, so its roundoff costs
iterations, never accuracy.

The host-side code is a numpy copy of the JAX package's; the device half
(``_chebyshev_smooth``, ``twogrid_apply``) is torch, with the fine operator
applied by the CUDA band kernel (ops/band_kernel.py).  The flat multilevel
cycle (``multilevel_apply``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .band import rect_band_mv, rect_band_tmv
from .band_kernel import band_mv_f32


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
    (an IEEE f32 GEMM: TF32 is off, see config.py), Chebyshev
    post-smooth."""

    def K_mv(x):
        return band_mv_f32(pack, x, layout)

    sm = {"dinv": dinv, "lmax": lmax}
    e = _chebyshev_smooth(sm, K_mv, r32, steps=smooth_steps)
    res = r32 - K_mv(e)
    rc = rect_band_tmv(Pt, res, rl, slots)
    ec = rc @ Kc_inv.T
    e = e + rect_band_mv(Pt, ec, rl, slots)
    return _chebyshev_smooth(sm, K_mv, r32, e0=e, steps=smooth_steps)
