"""Host f64 sparse-LU oracles (independent of the device path).

Assemble the complex operator A = K(theta) - omega^2 M of the
Dirichlet-reduced system, without equilibration or reordering, from the
host operator bundle of either path, and solve it with scipy's ``splu``
per frequency, refined by ``REFINE_STEPS`` steps of iterative refinement
whose residuals b - A u are computed in ``np.longdouble`` (80-bit on x86)
from the same f64 data.  The refinement gives the solution of the f64
system: a plain f64 LU solve carries eps * kappa, which at a resonance
peak of a fine mesh reaches 1.7e-6 of the FRF (the pure-bending plate at
n = 13862; 4.8e-7 at the 21k laminate; a host computation,
.probes/peak_floor.py).  The complex stiffness K = K_re + i K_im comes
from the material's split moduli, so per-modulus loss factors give a
K_im of their own; a material whose transform depends on the frequency is
evaluated at each frequency's omega (the reference's per-frequency
transform, Problem.py:397-399):

* ``splu_frf`` — the FRF: the accelerometer magnitude on the 3-field path,
  the complex test-point amplitude on the symmetric path (the check
  ``.probes/scale_tier.py`` and ``bench.py`` run against the JAX package,
  there without the refinement);
* ``splu_adjoint`` — the adjoint solve of the sweep's real split-complex
  system, mapped into the sweep's equilibrated, band-permuted space.
"""
from __future__ import annotations

import numpy as np

REFINE_STEPS = 3


def _moduli(problem, theta, omega=0.0):
    """Complex moduli at ``theta`` and ``omega``, numpy complex128: (A, B,
    D) on the 3-field path, D on the symmetric path."""
    import torch

    th = torch.as_tensor(np.asarray(theta, np.float64))
    om = torch.as_tensor(float(omega), dtype=torch.float64)
    h = problem.geometry.height
    if problem.is_symmetric_path:
        re, im = problem.material.d_split(th, h, om)
        return re.numpy() + 1j * im.numpy()
    return tuple(re.numpy() + 1j * im.numpy()
                 for re, im in problem.material.abd_split(th, h, om))


def _operator(problem, theta, dtype=np.complex128, omega=0.0):
    """(K, M, bK): complex stiffness K(theta, omega) (with its loss
    factors) and real mass M as CSC matrices, and the stiffness lift bK, on
    the free DOFs in their original order, combined in ``dtype`` from the
    f64 data."""
    import scipy.sparse as sp

    from .fem.assembly import MODULI_INDICES

    p = problem
    op = p.op
    n = p.n_free
    real = np.longdouble if dtype == np.clongdouble else np.float64
    if p.is_symmetric_path:
        D = _moduli(p, theta, omega).astype(dtype)
        # summed over the moduli in order, entry by entry (the JAX
        # package's einsum; a matmul would round otherwise)
        K_flat = np.einsum("k,kn->n", D, op.Ks.astype(real))
        bK = np.einsum("k,kn->n", D, op.fKs.astype(real))
    else:
        Av, Bv, Dv = (c.astype(dtype) for c in _moduli(p, theta, omega))
        K_flat = sum(Av[i] * op.mats["A" + s].astype(real)
                     + Bv[i] * op.mats["B" + s].astype(real)
                     + Dv[i] * op.mats["D" + s].astype(real)
                     for i, s in enumerate(MODULI_INDICES))
        bK = sum(Av[i] * op.lifts["A" + s].astype(real)
                 + Bv[i] * op.lifts["B" + s].astype(real)
                 + Dv[i] * op.lifts["D" + s].astype(real)
                 for i, s in enumerate(MODULI_INDICES))
    rows, cols = op.pattern.rows, op.pattern.cols
    K = sp.csc_matrix((K_flat, (rows, cols)), shape=(n, n))
    M = sp.csc_matrix((p.MInertia.astype(dtype), (rows, cols)), shape=(n, n))
    return K, M, bK


def _solver(problem, theta, omega=0.0):
    """solve(f, b, adjoint=False): the refined LU solution (longdouble) of
    A(f) u = b, or A(f)^H u = b, for a longdouble right-hand side b, with
    the material's moduli at ``omega``."""
    import scipy.sparse.linalg as spla

    K, M, _ = _operator(problem, theta, omega=omega)
    Kl, Ml, _ = _operator(problem, theta, np.clongdouble, omega)

    def solve(f, b, adjoint=False):
        A = K - (2.0 * np.pi * f) ** 2 * M
        Al = (Kl - (2.0 * np.pi * np.longdouble(f)) ** 2 * Ml).tocsr()
        if adjoint:
            A, Al = A.conj().T, Al.conj().T.tocsr()
        lu = spla.splu(A.tocsc())
        u = lu.solve(b.astype(np.complex128)).astype(np.clongdouble)
        for _ in range(REFINE_STEPS):
            u = u + lu.solve((b - Al @ u).astype(np.complex128))
        return u

    return solve


def splu_frf(problem, freqs, params=None) -> np.ndarray:
    """FRF at ``freqs`` [Hz] for ``params`` (default: the material's), from
    one refined f64 complex ``splu`` per frequency: |FRF| (3-field path) or
    the complex amplitude (symmetric path).  A frequency-dependent material
    transform is evaluated at each frequency's omega."""
    p = problem
    theta = np.asarray(p.parameters if params is None else params, np.float64)
    op = p.op
    L = np.longdouble
    fI = p.fInertia.astype(L)
    per_freq = p._transform_is_freq_dependent()
    fixed = None if per_freq else (_operator(p, theta, np.clongdouble)[2],
                                   _solver(p, theta))

    def solve(f):
        if per_freq:
            om = 2.0 * np.pi * f
            bK, refined = (_operator(p, theta, np.clongdouble, om)[2],
                           _solver(p, theta, om))
        else:
            bK, refined = fixed
        return refined(f, bK - (2.0 * np.pi * L(f)) ** 2 * fI)

    fr = np.atleast_1d(np.asarray(freqs, np.float64))
    if p.is_symmetric_path:
        c = op.interpolation_vector.astype(L)
        c0 = op.interpolation_value_from_bc
        return np.asarray([complex(c0 + c @ solve(f)) for f in fr])

    def row(name):
        R, r0 = op.readout[name]
        return R.mean(axis=0).astype(L), L(r0.mean())

    cu, ou = row("u")
    cv, ov = row("v")
    cw, ow = row("w")
    cwx, owx = row("wx")
    cwy, owy = row("wy")
    acc = p.accelerometer
    eff = L(acc.effective_height * acc.height)
    ts = L(acc.transverse_sensitivity)
    out = []
    for f in fr:
        u = solve(f)
        uu = (cu - eff * cwx) @ u + (ou - eff * owx)
        vv = (cv - eff * cwy) @ u + (ov - eff * owy)
        ww = cw @ u + ow
        out.append(float(np.sqrt((abs(uu) * ts) ** 2 + (abs(vv) * ts) ** 2
                                 + abs(ww) ** 2)))
    return np.asarray(out)


def splu_adjoint(problem, freqs, G_re, G_im, params=None):
    """(Y_re, Y_im), each (F, n): the adjoint solves of the sweep at
    ``freqs`` [Hz] for right-hand sides G (F, n) given in the sweep's
    space (equilibrated by S = diag(scale), RCM-permuted by P on the band
    layout; P = I on the flat layout).

    The sweep solves A_s u = b with A_s = S P A P^T S.  The transpose of
    its real split-complex form [[Re, -Im], [Im, Re]] is the split form of
    A_s^H, so Y solves A_s^H y = g (g = G_re + i G_im): here
    z = A^H^-1 (P^T S^-1 g) by one refined f64 complex ``splu`` of A^H per
    frequency, and y = S^-1 P z.
    """
    p = problem
    theta = np.asarray(p.parameters if params is None else params, np.float64)
    refined = _solver(p, theta)
    lay = p._band_layout
    perm = np.arange(p.n_free) if lay is None else lay.perm
    s = p._eq_scale[perm]                      # S in the permuted order
    g = np.asarray(G_re, np.float64) + 1j * np.asarray(G_im, np.float64)
    Y = np.empty_like(g)
    for i, f in enumerate(np.atleast_1d(np.asarray(freqs, np.float64))):
        w = np.empty(g.shape[1], np.clongdouble)
        w[perm] = g[i] / s
        Y[i] = (refined(f, w, adjoint=True)[perm] / s).astype(np.complex128)
    return Y.real, Y.imag
