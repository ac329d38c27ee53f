"""Host f64 sparse-LU oracles (independent of the device path).

Assemble the complex operator A = K(theta) - omega^2 M of the
Dirichlet-reduced system, without equilibration or reordering, from the
host operator bundle, and solve it with scipy's ``splu`` per frequency:

* ``splu_frf`` — the FRF, through the accelerometer readout (the check
  ``.probes/scale_tier.py`` and ``bench.py`` run against the JAX package);
* ``splu_adjoint`` — the adjoint solve of the sweep's real split-complex
  system, mapped into the sweep's equilibrated, band-permuted space.
"""
from __future__ import annotations

import numpy as np


def _operator(problem, theta):
    """(K, M, bK): complex f64 CSC stiffness K(theta) (with its loss
    factor), real mass M, and the stiffness lift bK, on the free DOFs in
    their original order."""
    import scipy.sparse as sp

    from .fem.assembly import MODULI_INDICES

    p = problem
    op = p.op
    n = p.n_free
    Av, Bv, Dv = p.material.reference_coeffs(theta, p.geometry.height)
    loss = 1.0 + 1j * theta[p.material._loss_factor_index]
    K_flat = sum(Av[i] * op.mats["A" + s] + Bv[i] * op.mats["B" + s]
                 + Dv[i] * op.mats["D" + s]
                 for i, s in enumerate(MODULI_INDICES)) * loss
    bK = sum(Av[i] * op.lifts["A" + s] + Bv[i] * op.lifts["B" + s]
             + Dv[i] * op.lifts["D" + s]
             for i, s in enumerate(MODULI_INDICES)) * loss
    rows, cols = op.pattern.rows, op.pattern.cols
    K = sp.csc_matrix((K_flat, (rows, cols)), shape=(n, n))
    M = sp.csc_matrix((p.MInertia.astype(complex), (rows, cols)), shape=(n, n))
    return K, M, bK


def splu_frf(problem, freqs, params=None) -> np.ndarray:
    """|FRF| at ``freqs`` [Hz] for ``params`` (default: the material's),
    from one f64 complex ``splu`` per frequency."""
    import scipy.sparse.linalg as spla

    p = problem
    theta = np.asarray(p.parameters if params is None else params, np.float64)
    op = p.op
    K, M, bK = _operator(p, theta)

    def row(name):
        R, r0 = op.readout[name]
        return R.mean(axis=0), r0.mean()

    cu, ou = row("u")
    cv, ov = row("v")
    cw, ow = row("w")
    cwx, owx = row("wx")
    cwy, owy = row("wy")
    acc = p.accelerometer
    eff = acc.effective_height * acc.height
    ts = acc.transverse_sensitivity
    out = []
    for f in np.atleast_1d(np.asarray(freqs, np.float64)):
        om = 2 * np.pi * f
        u = spla.splu((K - om**2 * M).tocsc()).solve(bK - om**2 * p.fInertia)
        uu = (cu - eff * cwx) @ u + (ou - eff * owx)
        vv = (cv - eff * cwy) @ u + (ov - eff * owy)
        ww = cw @ u + ow
        out.append(np.sqrt((abs(uu) * ts) ** 2 + (abs(vv) * ts) ** 2
                           + abs(ww) ** 2))
    return np.asarray(out)


def splu_adjoint(problem, freqs, G_re, G_im, params=None):
    """(Y_re, Y_im), each (F, n): the adjoint solves of the sweep at
    ``freqs`` [Hz] for right-hand sides G (F, n) given in the sweep's
    space (equilibrated by S = diag(scale), RCM-permuted by P on the band
    layout; P = I on the flat layout).

    The sweep solves A_s u = b with A_s = S P A P^T S.  The transpose of
    its real split-complex form [[Re, -Im], [Im, Re]] is the split form of
    A_s^H, so Y solves A_s^H y = g (g = G_re + i G_im): here
    z = A^H^-1 (P^T S^-1 g) by one f64 complex ``splu`` of A^H per
    frequency, and y = S^-1 P z.
    """
    import scipy.sparse.linalg as spla

    p = problem
    theta = np.asarray(p.parameters if params is None else params, np.float64)
    K, M, _ = _operator(p, theta)
    lay = p._band_layout
    perm = np.arange(p.n_free) if lay is None else lay.perm
    s = p._eq_scale[perm]                      # S in the permuted order
    g = np.asarray(G_re, np.float64) + 1j * np.asarray(G_im, np.float64)
    Y = np.empty_like(g)
    for i, f in enumerate(np.atleast_1d(np.asarray(freqs, np.float64))):
        om = 2 * np.pi * f
        AH = (K - om**2 * M).conj().T.tocsc()
        w = np.empty(g.shape[1], complex)
        w[perm] = g[i] / s
        z = spla.splu(AH).solve(w)
        Y[i] = z[perm] / s
    return Y.real, Y.imag
