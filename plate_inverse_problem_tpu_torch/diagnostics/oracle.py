"""f64 sparse-LU oracle for FRF accuracy audits (port of the JAX package's
``diagnostics/oracle.py``).

The mixed engine's FGMRES has no per-solve convergence signal a caller
reads from the FRF; a silently unconverged lane would surface only as a
wrong FRF value.  This module makes that failure mode *detectable from the
public API*: it re-solves a handful of frequencies (always including the
resonance peak — the worst-conditioned point) with scipy's f64 ``splu`` on
the host — the same arithmetic as the reference's UMFPACK recipe
(InnerState.h:240-305) — and reports the worst relative readout error of
the engine's sweep (``oracle_check``).  ``polish_peaks`` feeds one exact
host residual at the scanned |FRF| peaks back through the engine.

The system is the port's own host operator (``oracle._operator``, the
unscaled Dirichlet-reduced A = K - omega^2 M in complex128 from the f64
data), solved by plain ``splu``: the JAX package's recipe.  At a fine
mesh's resonance peak plain splu is itself eps * kappa off (1.7e-6 at the
13862-DOF pure-bending peak); ``oracle.splu_frf`` refines it with
longdouble residuals and is the port's oracle for such points.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.problem import _numpy as _host

__all__ = ["frf_oracle", "oracle_check", "polish_peaks"]


def _host_system(problem, params, omega: float):
    """(A_dyn_csc, rhs) of the UNSCALED reduced system at one angular
    frequency, complex128 from the f64 host data; a frequency-dependent
    material is evaluated at ``omega``.  A keeps every slot of the pattern,
    the exact zeros too (as the JAX function's does: a sparse difference
    K - omega^2 M would drop them, and splu would order another
    structure)."""
    import scipy.sparse as sp

    from ..oracle import _operator

    freq_dep = problem._transform_is_freq_dependent()
    K, M, bK = _operator(problem, np.asarray(params, np.float64),
                         omega=omega if freq_dep else 0.0)
    # K and M come from one (rows, cols) pattern: the same CSC structure
    A = sp.csc_matrix((K.data - omega ** 2 * M.data, K.indices, K.indptr),
                      shape=K.shape)
    rhs = bK - omega ** 2 * problem.fInertia
    return A, rhs


def _readout(problem, u: np.ndarray):
    """Scalar FRF readout of a full solution vector — same formula as the
    cores (complex interpolation for the symm path, accelerometer
    magnitude for the 3-field path)."""
    op = problem.op
    if problem.is_symmetric_path:
        return (op.interpolation_value_from_bc
                + u @ np.asarray(op.interpolation_vector))
    acc = problem.accelerometer
    eff = acc.effective_height * acc.height
    ts = acc.transverse_sensitivity

    def row(name):
        R, r0 = op.readout[name]
        return np.asarray(R.mean(axis=0)), float(r0.mean())

    cu, ou = row("u")
    cv, ov = row("v")
    cw, ow = row("w")
    cwx, owx = row("wx")
    cwy, owy = row("wy")
    uu = (cu - eff * cwx) @ u + (ou - eff * owx)
    vv = (cv - eff * cwy) @ u + (ov - eff * owy)
    ww = cw @ u + ow
    return np.sqrt((abs(uu) * ts) ** 2 + (abs(vv) * ts) ** 2 + abs(ww) ** 2)


def _exact_system(problem, params, f_hz: float):
    """(A, rhs) of the unscaled reduced system at ``f_hz`` in extended
    precision (``np.clongdouble``, 80-bit on x86) from the f64 data: the
    system ``oracle.splu_frf`` refines against, whose residual of an f64
    iterate is exact to far below the f64 solution's own error."""
    from ..oracle import _operator

    L = np.longdouble
    om = 2.0 * np.pi * L(f_hz)
    freq_dep = problem._transform_is_freq_dependent()
    K, M, bK = _operator(problem, params, np.clongdouble,
                         omega=float(om) if freq_dep else 0.0)
    return (K - om ** 2 * M).tocsr(), bK - om ** 2 * problem.fInertia.astype(L)


def frf_oracle(problem, freqs_hz, params=None) -> np.ndarray:
    """Reference-recipe FRF (f64 splu per frequency) at ``freqs_hz``."""
    import scipy.sparse.linalg as spla

    if params is None:
        params = problem.parameters
    params = _host(params).astype(np.float64)
    out = []
    for f in np.atleast_1d(np.asarray(freqs_hz, dtype=np.float64)):
        om = 2.0 * np.pi * float(f)
        A, rhs = _host_system(problem, params, om)
        u = spla.splu(A).solve(rhs)
        out.append(_readout(problem, u))
    return np.asarray(out)


def _peak_indices(mag: np.ndarray, peaks) -> list[int]:
    """Indices to polish: explicit index list, or the ``peaks`` largest
    local maxima of |FRF| (the global argmax always included)."""
    if not np.isscalar(peaks):
        return sorted({int(i) for i in np.asarray(peaks).ravel()})
    k = int(peaks)
    if k < 1:
        return []
    interior = np.arange(1, mag.size - 1)
    is_max = (mag[interior] >= mag[interior - 1]) & (mag[interior] >= mag[interior + 1])
    cand = interior[is_max]
    cand = cand[np.argsort(mag[cand])[::-1]][:k]
    return sorted({int(np.argmax(mag)), *cand.tolist()}
                  if cand.size else {int(np.argmax(mag))})


def polish_peaks(problem, freqs_hz, fr=None, params=None, peaks=1,
                 passes: int = 1):
    """Host-exact residual correction at scanned |FRF| peaks.

    An in-engine residual of a near-resonant solve cancels by 1e6-1e9, so
    the FGMRES solve's accuracy AT a scanned resonance peak is bounded by
    that cancellation and by its stopping rule; off-peak points are
    unaffected.  The remedy is to compute ONE residual of the converged
    iterate on the HOST, exactly, and feed it back through the engine as
    a fresh right-hand side (on the card the correction sweep runs K3
    and, above 12288 DOF, K1 as any sweep does).  The JAX package forms
    that residual in f64; the port forms it in extended precision
    (``_exact_system``), because an f64 residual of a near-resonant
    iterate carries eps |A| |u|, the plain splu's own floor: on the 21k
    plate's peak an f64 residual took the peak from 7.6e-8 to 4.4e-7 off
    the refined splu (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
    phase 13 (b)).

    Each pass costs one host SpMV (O(nnz), no factorization) plus one
    batched adjoint sweep over the selected peaks.  The modal and direct
    engines are factorisations with no Krylov solve to correct: there the
    peak values are replaced by the full :func:`frf_oracle` (host f64
    splu — exact, pays a factorization).

    Parameters: ``peaks`` — int k (polish the k largest |FRF| local maxima)
    or an explicit index list; ``passes`` — host-residual correction rounds
    (1 suffices; 2 for deliberately small Krylov budgets).  ``fr``: an
    existing sweep over ``freqs_hz`` to polish (computed via
    ``solveForward`` when omitted; a tensor on the card is read back).

    Returns ``(fr_polished, info)``: a numpy array, and ``info`` with the
    polished indices/frequencies and the mode ('residual' or 'oracle').

    Reference counterpart: none — the reference's UMFPACK solves (
    InnerState.h:164-308) run in exactly-rounded host f64 throughout and
    need no peak polish.
    """
    freqs_hz = np.asarray(freqs_hz, dtype=np.float64)
    if params is None:
        params = problem.parameters
    params = _host(params).astype(np.float64)
    if fr is None:
        fr = problem.solveForward(freqs_hz, params)
    fr = np.array(_host(fr), copy=True)
    idxs = _peak_indices(np.abs(fr), peaks)
    if not idxs:
        return fr, {"indices": [], "mode": "none"}

    core, od = problem.getFRCore()
    if core.engine != "mixed":
        for i in idxs:
            fr[i] = frf_oracle(problem, freqs_hz[i], params)[0]
        return fr, {"indices": idxs, "mode": "oracle",
                    "freqs_hz": [float(freqs_hz[i]) for i in idxs]}

    scale = problem._eq_scale
    layout = problem._band_layout
    perm = None if layout is None else np.asarray(layout.perm)

    def to_phys(vt):
        """device (equilibrated, RCM-permuted) -> physical solution."""
        if perm is not None:
            vp = np.empty_like(vt)
            vp[perm] = vt
        else:
            vp = vt
        return scale * vp

    def to_dev(v):
        """physical rhs -> device (equilibrated, RCM-permuted) rhs."""
        vt = scale * v
        return vt[perm] if perm is not None else vt

    dev = problem.device
    th = torch.as_tensor(params, device=dev)
    fsel = torch.as_tensor(freqs_hz[idxs], device=dev)

    with torch.no_grad():
        U_re, U_im = (_host(u) for u in core.sweep_u(fsel, th, od))
    us = [to_phys(U_re[k] + 1j * U_im[k]) for k in range(len(idxs))]
    systems = [_exact_system(problem, params, freqs_hz[i]) for i in idxs]

    # monotone safeguard: every pass is accepted per peak only if it
    # LOWERED the exact host residual norm — a correction through an
    # engine solve that is not contracting (e.g. a deliberately starved
    # Krylov budget far from the basis theta) would otherwise amplify;
    # with the safeguard, polish can never return worse than its input.
    best_u = list(us)
    best_rn = [np.inf] * len(idxs)
    improved = [False] * len(idxs)

    def _residuals(cur):
        return [rhs - A @ u.astype(np.clongdouble)
                for (A, rhs), u in zip(systems, cur)]

    for p_i in range(max(1, int(passes)) + 1):
        rs = _residuals(us)
        for k, r in enumerate(rs):
            rn = float(np.sqrt(np.sum(np.abs(r) ** 2)))
            if rn < best_rn[k]:
                best_rn[k] = rn
                best_u[k] = us[k]
                improved[k] = p_i > 0
        if p_i == max(1, int(passes)):
            break
        # exact host residuals of the current iterates, batched back
        # through the engine.  A is complex symmetric, so A d = r solves
        # through the adjoint hook (conj(A) y = g) as d = conj(y) with
        # g = conj(r).
        rts = np.stack([to_dev(r.astype(np.complex128)) for r in rs])
        G_re = torch.as_tensor(np.ascontiguousarray(rts.real), device=dev)
        G_im = torch.as_tensor(np.ascontiguousarray(-rts.imag), device=dev)
        with torch.no_grad():
            Y_re, Y_im = (_host(y) for y in core.sweep_adj(fsel, th, od,
                                                            G_re, G_im))
        us = [u + to_phys(Y_re[k] - 1j * Y_im[k])
              for k, u in enumerate(us)]

    for k, i in enumerate(idxs):
        if improved[k]:
            # host readout of the polished solution; unimproved peaks keep
            # the engine's own value verbatim
            fr[i] = _readout(problem, best_u[k])
    return fr, {"indices": idxs, "mode": "residual", "passes": int(passes),
                "improved": improved,
                "freqs_hz": [float(freqs_hz[i]) for i in idxs]}


def oracle_check(problem, freqs_hz, params=None, fr=None,
                 n_points: int = 4) -> dict:
    """Audit an engine sweep against the f64 oracle at ``n_points``
    frequencies: the |FRF| peak (always) plus points spread across the
    band.  ``fr``: the engine's own sweep over ``freqs_hz`` (computed via
    ``getFRFunction`` when omitted; a tensor on the card is read back).

    Returns ``{"worst_rel_err", "at_hz", "checked_hz", "engine"}``.
    """
    freqs_hz = np.asarray(freqs_hz, dtype=np.float64)
    if params is None:
        params = problem.parameters
    params = _host(params).astype(np.float64)
    if fr is None:
        fr = problem.getFRFunction()(freqs_hz, params)
    fr = _host(fr)

    F = freqs_hz.size
    idxs = {int(np.argmax(np.abs(fr)))}
    for i in np.linspace(0, F - 1, max(1, n_points - 1)).round().astype(int):
        idxs.add(int(i))
    idxs = sorted(idxs)

    worst, at = 0.0, float(freqs_hz[idxs[0]])
    for i in idxs:
        ref_i = frf_oracle(problem, freqs_hz[i], params)[0]
        rel = abs(fr[i] - ref_i) / max(abs(ref_i), 1e-300)
        if rel > worst:
            worst, at = float(rel), float(freqs_hz[i])
    return {
        "worst_rel_err": worst,
        "at_hz": at,
        "checked_hz": [float(freqs_hz[i]) for i in idxs],
        "engine": problem._engine(),
    }
