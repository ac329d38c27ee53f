"""Independent spectral (Rayleigh-Ritz) oracle for the clamped strip.

A mesh-free, FEM-free solution of the Kirchhoff plate eigenproblem on the
rectangular strip [0, L] x [-b/2, b/2], clamped at x = L (w = w_x = 0),
free on the other edges, carrying the smeared accelerometer inertia over a
disk — the exact configuration of the reference's golden 'symm' setup
(reference examples/basics.py; geometry/symm.edp).

Basis: cantilever beam eigenfunctions in x (clamped at x = L) tensored
with free-free beam functions in y; full Kirchhoff bending energy
including the Poisson cross terms; translational + rotary inertia of both
plate and accelerometer disk.  Everything reduces to dense quadrature of
smooth 1D/2D integrands, so the computation shares NO code or
discretization with the FEM stack — agreement validates the assembled
operator independently (tests/test_golden_parity.py).
"""
from __future__ import annotations

import numpy as np


def _cantilever_modes(n: int, xs: np.ndarray, L: float):
    """First ``n`` cantilever (clamped at x=L, free at x=0) beam modes and
    their first/second derivatives, evaluated on ``xs``."""
    # standard roots of 1 + cos(k L) cosh(k L) = 0
    from scipy.optimize import brentq

    roots = []
    k = 0
    x0 = 1e-3
    while len(roots) < n:
        x1 = x0 + 0.05
        f0 = 1 + np.cos(x0) * np.cosh(x0)
        f1 = 1 + np.cos(x1) * np.cosh(x1)
        if f0 * f1 < 0:
            roots.append(brentq(lambda t: 1 + np.cos(t) * np.cosh(t), x0, x1))
        x0 = x1
        k += 1
        if k > 100000:
            raise RuntimeError("cantilever root search failed")
    roots = np.asarray(roots)

    # mode measured from the clamped end: xi = (L - x)/L in [0, 1].
    # cosh/sinh combinations are rewritten in exponentials with the exactly
    # cancelled (1 - sigma) factor — the naive (cosh - cos) - sig*(sinh - sin)
    # form loses all precision for k*xi > ~35 (cancellation of e^{k xi}/2
    # terms) and poisons the Gram matrices at large bases.
    xi = (L - xs[None, :]) / L
    kL = roots[:, None]
    c_k, s_k = np.cos(roots)[:, None], np.sin(roots)[:, None]
    den = np.cosh(roots)[:, None] + c_k
    sig = (np.sinh(roots)[:, None] - s_k) / den

    z = kL * xi
    ez = np.exp(-z)
    c, s = np.cos(z), np.sin(z)
    # (1 - sigma) e^{z} without cancellation:
    #   e^{kL}(1 - sigma) = (1 + (cos kL + sin kL) e^{kL}) / (cosh kL + cos kL)
    grow = np.exp(z - kL) * ((1.0 + (c_k + s_k) * np.exp(roots)[:, None]) / den)
    # A = cosh z - sig sinh z,  B = sinh z - sig cosh z
    A = 0.5 * (grow + (1.0 + sig) * ez)
    B = 0.5 * (grow - (1.0 + sig) * ez)
    W = A - c + sig * s
    dW_dxi = kL * (B + s + sig * c)
    d2W_dxi2 = kL ** 2 * (A + c - sig * s)
    # d/dx = -(1/L) d/dxi
    return W, -dW_dxi / L, d2W_dxi2 / L ** 2


def _freefree_modes(m: int, ys: np.ndarray, b: float):
    """1, linear, and free-free beam modes on [-b/2, b/2] (+ derivatives)."""
    from scipy.optimize import brentq

    funcs = [np.ones_like(ys), 2.0 * ys / b]
    dfuncs = [np.zeros_like(ys), np.full_like(ys, 2.0 / b)]
    d2funcs = [np.zeros_like(ys), np.zeros_like(ys)]

    # roots of cos(kb)cosh(kb) = 1 (free-free), skipping rigid modes
    roots = []
    x0 = 1.0
    while len(roots) < max(m - 2, 0):
        x1 = x0 + 0.05
        f = lambda t: np.cos(t) * np.cosh(t) - 1.0  # noqa: E731
        if f(x0) * f(x1) < 0:
            r = brentq(f, x0, x1)
            if r > 1e-6:
                roots.append(r)
        x0 = x1
    eta = (ys + b / 2) / b
    for r in roots:
        sig = (np.cosh(r) - np.cos(r)) / (np.sinh(r) - np.sin(r))
        z = r * eta
        c, s = np.cos(z), np.sin(z)
        ez = np.exp(-z)
        # (1 - sigma) e^{z} in cancellation-free form (see cantilever case)
        grow = np.exp(z - r) * ((-1.0 + (np.cos(r) - np.sin(r)) * np.exp(r))
                                / (np.sinh(r) - np.sin(r)))
        A = 0.5 * (grow + (1.0 + sig) * ez)   # cosh - sig sinh
        B = 0.5 * (grow - (1.0 + sig) * ez)   # sinh - sig cosh
        funcs.append(A + c - sig * s)
        dfuncs.append((r / b) * (B - s - sig * c))
        d2funcs.append((r / b) ** 2 * (A - c + sig * s))
    return (np.stack(funcs[:m]), np.stack(dfuncs[:m]), np.stack(d2funcs[:m]))


def clamped_strip_frequencies(L, b, h, E, nu, rho, accel=None,
                              accel_pos=(0.0, 0.0), n_x=16, n_y=6,
                              n_modes=6, nq=220):
    """First ``n_modes`` natural frequencies [Hz] of the clamped-free strip.

    ``accel``: optional Accelerometer-like object (mass, radius, height)
    smeared over the disk at ``accel_pos`` exactly as Problem does
    (I0Corr/I2Corr, reference Problem.py:361-374).
    """
    D = E * h ** 3 / (12.0 * (1.0 - nu * nu))
    I0 = rho * h
    I2 = rho * h ** 3 / 12.0

    # Gauss-Legendre grids
    gx, wx = np.polynomial.legendre.leggauss(nq)
    xs = 0.5 * L * (gx + 1.0)
    wxs = 0.5 * L * wx
    gy, wy = np.polynomial.legendre.leggauss(max(nq // 3, 40))
    ys = 0.5 * b * gy
    wys = 0.5 * b * wy

    X, dX, d2X = _cantilever_modes(n_x, xs, L)
    Y, dY, d2Y = _freefree_modes(n_y, ys, b)

    def outer(u, v):
        return np.einsum("ix,jy->ijxy", u, v).reshape(n_x * n_y, xs.size, ys.size)

    W = outer(X, Y)
    Wx = outer(dX, Y)
    Wy = outer(X, dY)
    Wxx = outer(d2X, Y)
    Wyy = outer(X, d2Y)
    Wxy = outer(dX, dY)

    wq = wxs[:, None] * wys[None, :]

    def integ(A, B):
        return np.einsum("nxy,mxy,xy->nm", A, B, wq)

    K = D * (integ(Wxx, Wxx) + integ(Wyy, Wyy)
             + nu * (integ(Wxx, Wyy) + integ(Wyy, Wxx))
             + 2.0 * (1.0 - nu) * integ(Wxy, Wxy))
    M = I0 * integ(W, W) + I2 * (integ(Wx, Wx) + integ(Wy, Wy))

    if accel is not None:
        rho_c = accel.mass / (np.pi * accel.radius ** 2) / accel.height
        I0c = accel.height * rho_c
        I2c = rho_c / 3.0 * ((h / 2.0 + accel.height) ** 3 - h ** 3 / 8.0)
        cx, cy = accel_pos
        # exact polar quadrature over the disk (the tensor-grid indicator
        # would re-introduce an O(grid) discontinuity error)
        nr, na = 48, 96
        gr, wr = np.polynomial.legendre.leggauss(nr)
        # s = (g+1)/2, r = R sqrt(s):  r dr = (R^2/2) ds = (R^2/4) dg
        rr = accel.radius * np.sqrt(0.5 * (gr + 1.0))
        wrr = 0.25 * accel.radius ** 2 * wr
        th = 2.0 * np.pi * (np.arange(na) + 0.5) / na
        wth = 2.0 * np.pi / na
        px = (cx + rr[:, None] * np.cos(th)[None, :]).ravel()
        py = (cy + rr[:, None] * np.sin(th)[None, :]).ravel()
        wp = (wrr[:, None] * wth * np.ones(na)[None, :]).ravel()

        Xp, dXp, _ = _cantilever_modes(n_x, px, L)
        Yp, dYp, _ = _freefree_modes(n_y, py, b)

        def pouter(u, v):
            return np.einsum("ip,jp->ijp", u, v).reshape(n_x * n_y, px.size)

        Wp = pouter(Xp, Yp)
        Wpx = pouter(dXp, Yp)
        Wpy = pouter(Xp, dYp)

        def integ_d(A, B):
            return np.einsum("np,mp,p->nm", A, B, wp)

        M = M + I0c * integ_d(Wp, Wp) + I2c * (integ_d(Wpx, Wpx)
                                               + integ_d(Wpy, Wpy))

    from scipy.linalg import eigh

    lam = eigh(0.5 * (K + K.T), 0.5 * (M + M.T), eigvals_only=True)
    lam = lam[lam > 0]
    return np.sqrt(lam[:n_modes]) / (2.0 * np.pi)
