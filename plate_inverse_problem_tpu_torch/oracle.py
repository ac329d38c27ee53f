"""Host f64 sparse-LU oracle for the FRF (independent of the device path).

Assembles the complex operator K(theta) - omega^2 M of the Dirichlet-reduced
system, without equilibration or reordering, from the host operator bundle,
solves it with scipy's ``splu`` per frequency and applies the accelerometer
readout — the check ``.probes/scale_tier.py`` and ``bench.py`` run against
the JAX package.
"""
from __future__ import annotations

import numpy as np


def splu_frf(problem, freqs, params=None) -> np.ndarray:
    """|FRF| at ``freqs`` [Hz] for ``params`` (default: the material's),
    from one f64 complex ``splu`` per frequency."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from .fem.assembly import MODULI_INDICES

    p = problem
    theta = np.asarray(p.parameters if params is None else params, np.float64)
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
