"""Gauss-Newton / Levenberg-Marquardt on a vector residual (JAX package
``optimize/second_order.py``).

The residual and its Jacobian come from the device (``ResidualFunction``,
the adjoint Jacobian); the normal equations are a tiny dense problem solved
on the host in numpy f64, so every tensor is moved to the host explicitly.
Newton and L-BFGS are not ported yet (ROADMAP Queue 1, item D).
"""
from __future__ import annotations

import numpy as np
import torch

from .local import optResult


def _host(v) -> np.ndarray:
    """numpy f64 copy of a tensor (any device) or an array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().astype(np.float64, copy=False)
    return np.asarray(v, dtype=np.float64)


class JointResidual:
    """Concatenation of several residual functions over one parameter vector.

    The remedy for weakly-identified anisotropic inversions: combine FRF
    datasets from multiple geometries / cuts of the same material into one
    Gauss-Newton problem.  Each element is a ``Problem.getResidualFunction``
    object (or any object with ``__call__`` and ``value_and_jac``); optional
    per-dataset weights.  Residuals and Jacobians come back as host numpy
    f64 arrays.
    """

    def __init__(self, residuals, weights=None):
        self._rs = list(residuals)
        if weights is None:
            weights = [1.0] * len(self._rs)
        self._ws = [float(w) for w in weights]

    def __call__(self, params):
        return np.concatenate([w * _host(r(params))
                               for r, w in zip(self._rs, self._ws)])

    def value_and_jac(self, params):
        vals, jacs = [], []
        for r, w in zip(self._rs, self._ws):
            if not hasattr(r, "value_and_jac"):
                raise NotImplementedError(
                    "A residual without value_and_jac needs a forward-mode "
                    "Jacobian of the whole callable, which is not ported yet "
                    "(ROADMAP Queue 1, item C: jac_mode='fwd').")
            v, J = r.value_and_jac(params)
            vals.append(w * _host(v))
            jacs.append(w * _host(J))
        return np.concatenate(vals), np.concatenate(jacs, axis=0)


def optimize_gauss_newton(resfn, x_0, N_steps=20, lm_damping=1e-3,
                          f_min=1e-16, backtrack=0.5, max_backtracks=15):
    """Gauss-Newton / Levenberg-Marquardt on a vector residual.

    ``resfn`` is a ``Problem.getResidualFunction`` object (or a
    ``JointResidual``): ``resfn(x)`` gives r and ``resfn.value_and_jac(x)``
    gives (r, J).  The normal-equations solve is a tiny host-side dense
    problem.  Returns the usual optResult record with f = mean squared
    residual and host numpy iterates.
    """
    if not hasattr(resfn, "value_and_jac"):
        raise NotImplementedError(
            "Gauss-Newton on a callable without value_and_jac needs a "
            "forward-mode Jacobian, which is not ported yet (ROADMAP Queue "
            "1, item C: jac_mode='fwd').")

    x = _host(x_0).copy()
    x_history, f_history, grad_history = [], [], []
    status = "Running"
    lam = lm_damping
    cur_f = None
    k = 0

    for k in range(N_steps):
        r, J = resfn.value_and_jac(x)
        r_h = _host(r)
        J_h = _host(J)
        m = r_h.size
        cur_f = float(r_h @ r_h) / m
        g = 2.0 * (J_h.T @ r_h) / m

        x_history.append(x)
        f_history.append(cur_f)
        grad_history.append(g)

        if cur_f <= f_min:
            status = "Converged"
            break

        JtJ = J_h.T @ J_h / m
        accepted = False
        for _ in range(max_backtracks):
            H = JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-30))
            try:
                step = np.linalg.solve(H, -0.5 * g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = x + step
            r_new = _host(resfn(x_new))
            f_new = float(r_new @ r_new) / m
            if f_new < cur_f:
                x = x_new
                lam = max(lam * backtrack, 1e-12)
                accepted = True
                break
            lam *= 4.0
        if not accepted:
            status = "Stalled"
            break

    return optResult(x, cur_f, f_history, x_history, grad_history, k, status)
