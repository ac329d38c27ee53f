"""Second-order and quasi-Newton optimizers (JAX package
``optimize/second_order.py``) as host loops.

* ``optimize_newton`` — damped Newton on the loss's value, gradient and
  Hessian (``get_model_newt``) with Armijo backtracking.
* ``optimize_lbfgs`` — L-BFGS with optax's defaults and zoom line search
  (the JAX package calls ``optax.lbfgs``; the card's machine has no optax,
  so the algorithm is written out here, step for step).
* ``optimize_gauss_newton`` / ``JointResidual`` — Gauss-Newton /
  Levenberg-Marquardt on a vector residual: the residual and its Jacobian
  come from the device (``ResidualFunction``) or, for a plain callable,
  from ``torch.func.jacfwd`` through it; the normal equations are a tiny
  dense problem solved on the host in numpy f64.

Every tensor is moved to the host explicitly; iterates and histories are
numpy f64.
"""
from __future__ import annotations

import numpy as np
import torch

from .local import _host, _value, _value_and_grad, get_model_newt, optResult


def _value_and_jac(r):
    """``x (numpy) -> (r, J)`` as f64 numpy: the residual's own
    ``value_and_jac`` where it has one, else ``torch.func.jacfwd`` of the
    plain callable (one shared primal, the tangents as a batch)."""
    if hasattr(r, "value_and_jac"):
        def vj(x):
            v, J = r.value_and_jac(x)
            return _host(v), _host(J)
        return vj

    def vj(x):
        def f(xt):
            out = r(xt)
            return out, out

        J, v = torch.func.jacfwd(f, has_aux=True)(torch.as_tensor(_host(x)))
        return _host(v), _host(J)
    return vj


def _residual(r):
    """``x (numpy) -> r`` as f64 numpy, for an object or a plain callable."""
    def value(x):
        with torch.no_grad():
            return _host(r(torch.as_tensor(_host(x))))
    return value


class JointResidual:
    """Concatenation of several residual functions over one parameter vector.

    The remedy for weakly-identified anisotropic inversions: combine FRF
    datasets from multiple geometries / cuts of the same material into one
    Gauss-Newton problem.  Each element is a ``Problem.getResidualFunction``
    object (or any object with ``__call__`` and ``value_and_jac``) or a
    plain callable of a torch f64 vector, differentiated by
    ``torch.func.jacfwd``; optional per-dataset weights.  Residuals and
    Jacobians come back as host numpy f64 arrays.
    """

    def __init__(self, residuals, weights=None):
        self._rs = list(residuals)
        if weights is None:
            weights = [1.0] * len(self._rs)
        self._ws = [float(w) for w in weights]

    def __call__(self, params):
        return np.concatenate([w * _residual(r)(params)
                               for r, w in zip(self._rs, self._ws)])

    def value_and_jac(self, params):
        vals, jacs = [], []
        for r, w in zip(self._rs, self._ws):
            v, J = _value_and_jac(r)(params)
            vals.append(w * v)
            jacs.append(w * J)
        return np.concatenate(vals), np.concatenate(jacs, axis=0)


def optimize_gauss_newton(resfn, x_0, N_steps=20, lm_damping=1e-3,
                          f_min=1e-16, backtrack=0.5, max_backtracks=15):
    """Gauss-Newton / Levenberg-Marquardt on a vector residual.

    ``resfn`` is a ``Problem.getResidualFunction`` object (or a
    ``JointResidual``): ``resfn(x)`` gives r and ``resfn.value_and_jac(x)``
    gives (r, J); or a plain callable of a torch f64 vector, whose J is
    ``torch.func.jacfwd`` of it.  The normal-equations solve is a tiny
    host-side dense problem.  Returns the usual optResult record with f =
    mean squared residual and host numpy iterates.
    """
    value_and_jac = _value_and_jac(resfn)
    residual = _residual(resfn)

    x = _host(x_0).copy()
    x_history, f_history, grad_history = [], [], []
    status = "Running"
    lam = lm_damping
    cur_f = None
    k = 0

    for k in range(N_steps):
        r_h, J_h = value_and_jac(x)
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
            r_new = residual(x_new)
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


def optimize_newton(f, x_0, N_steps=20, damping=1e-8, f_min=1e-16,
                    backtrack=0.5, max_backtracks=20):
    """Damped Newton with Armijo backtracking (JAX ``optimize_newton``):
    the step solves (B + lam I) s = -g with lam = ``damping`` x the mean
    Hessian diagonal, falls back to -g when that is singular or not a
    descent direction, and is halved until the loss falls."""
    update_model = get_model_newt(f)
    value = _value(f)

    x = _host(x_0).copy()
    x_history, f_history, grad_history = [], [], []
    status = "Running"
    cur_f = None
    k = 0

    for k in range(N_steps):
        cur_f, g, B = update_model(x)
        x_history.append(x)
        f_history.append(cur_f)
        grad_history.append(g)
        if cur_f <= f_min:
            status = "Converged"
            break

        lam = damping * np.trace(B) / B.shape[0]
        B_d = B + np.eye(B.shape[0], dtype=B.dtype) * lam
        try:
            step = np.linalg.solve(B_d, -g)
        except np.linalg.LinAlgError:
            step = -g

        # fall back to steepest descent if the Newton step is not a descent
        # direction
        if np.dot(step, g) > 0:
            step = -g

        t = 1.0
        accepted = False
        for _ in range(max_backtracks):
            new_f = value(x + t * step)
            if new_f < cur_f:
                x = x + t * step
                accepted = True
                break
            t *= backtrack
        if not accepted:
            status = "Stalled"
            break

    return optResult(x, cur_f, f_history, x_history, grad_history, k, status)


# ---------------------------------------------------------------------------
# L-BFGS: optax 0.2.6's ``lbfgs`` (optax/_src/alias.py), i.e.
# ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``, ``scale(-1)``
# and ``scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one")`` (optax/_src/transform.py,
# optax/_src/linesearch.py) with the zoom line search's defaults below
# ---------------------------------------------------------------------------

_ZOOM = dict(
    tol=0.0,                 # error tolerance of both Wolfe conditions
    increase_factor=2.0,     # step growth while no interval is found
    slope_rtol=1e-4,         # sufficient decrease (Armijo) constant
    curv_rtol=0.9,           # curvature constant
    approx_dec_rtol=1e-6,    # approximate Wolfe: relative value slack
    interval_threshold=1e-5,  # stepsize_precision: smallest interval
    max_linesearch_steps=20,  # lbfgs's function evaluations a step
)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)
    (optax ``_cubicmin``); NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]])
    A, B = d1 @ np.array([fb - fa - C * db, fc - fa - C * dc]) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa, fpa), (b, fb) (optax
    ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


def _zoom_linesearch(vg, x, upd, value, grad):
    """optax's zoom line search along ``upd`` from ``x`` (value and gradient
    there given): (stepsize, value, gradient) at the accepted step.

    Bracketing phase (``_search_interval``): stepsizes 1, 2, 4, ... until an
    interval holding a point of both (approximate) Wolfe conditions is
    found; zoom phase (``_zoom_into_interval``): cubic, quadratic or
    bisection trial points inside it.  On failure after ``max_steps``
    evaluations, the best point of sufficient decrease ("safe" step)."""
    z = _ZOOM
    max_steps = z["max_linesearch_steps"]
    slope_init = float(np.dot(upd, grad))
    value_init = value

    def on_line(step):
        v, g = vg(x + step * upd)
        return v, g, float(np.dot(g, upd))

    # np.maximum / np.minimum: a NaN (a step outside the domain) propagates
    # to the error, which then reads infinite
    def decrease_error(step, v, slope):
        err = v - value_init - z["slope_rtol"] * step * slope_init
        approx = slope - (2 * z["slope_rtol"] - 1.0) * slope_init
        approx = np.maximum(approx, v - value_init
                            - z["approx_dec_rtol"] * abs(value_init))
        err = float(np.maximum(np.minimum(approx, err), 0.0))
        return np.inf if np.isnan(err) else err

    def curvature_error(slope):
        err = float(np.maximum(abs(slope) - z["curv_rtol"] * abs(slope_init),
                               0.0))
        return np.inf if np.isnan(err) else err

    s = dict(count=0, stepsize=0.0, value=value, grad=grad, slope=slope_init,
             dec_err=np.inf, interval_found=False, done=False, failed=False,
             low=0.0, value_low=value, slope_low=slope_init, high=0.0,
             value_high=value, slope_high=slope_init, cubic_ref=0.0,
             value_cubic_ref=value, safe_stepsize=0.0, safe_value=value,
             safe_grad=grad)
    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            k = s["count"]
            if not s["interval_found"]:
                new = 1.0 if k == 0 else z["increase_factor"] * s["stepsize"]
                v, g, slope = on_line(new)
                dec = decrease_error(new, v, slope)
                err = max(dec, curvature_error(slope))
                if dec <= z["tol"]:
                    s.update(safe_stepsize=new, safe_value=v, safe_grad=g)
                high_new = dec > 0.0 or (v >= s["value"] and k > 0)
                low_new = slope >= 0.0 and not high_new
                prev = (s["stepsize"], s["value"], s["slope"])
                if low_new:
                    lo, hi = (new, v, slope), prev
                else:
                    lo, hi = prev, (new, v, slope)
                s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                         high=hi[0], value_high=hi[1], slope_high=hi[2],
                         cubic_ref=lo[0], value_cubic_ref=lo[1])
                s["interval_found"] = high_new or low_new or err <= z["tol"]
                s["done"] = err <= z["tol"]
                s["failed"] = k + 1 >= max_steps and not s["done"]
            else:
                low, high = s["low"], s["high"]
                delta = abs(high - low)
                left, right = min(high, low), max(high, low)
                cubic = _cubicmin(low, s["value_low"], s["slope_low"], high,
                                  s["value_high"], s["cubic_ref"],
                                  s["value_cubic_ref"])
                quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                                s["value_high"])
                if left + 0.2 * delta < cubic < right - 0.2 * delta:
                    new = cubic
                elif left + 0.1 * delta < quad < right - 0.1 * delta:
                    new = quad
                else:
                    new = (low + high) / 2.0
                v, g, slope = on_line(new)
                dec = decrease_error(new, v, slope)
                err = max(dec, curvature_error(slope))
                if dec <= z["tol"] and v < s["safe_value"]:
                    s.update(safe_stepsize=new, safe_value=v, safe_grad=g)
                s["done"] = err <= z["tol"]
                high_mid = dec > 0.0 or v >= s["value_low"]
                high_low = slope * (high - low) >= 0.0 and not high_mid
                mid = (new, v, slope)
                lo = (low, s["value_low"], s["slope_low"])
                hi = mid if high_mid else (high, s["value_high"],
                                           s["slope_high"])
                if high_low:
                    hi = lo
                if not high_mid:
                    lo = mid
                if high_mid or high_low:
                    ref = (high, s["value_high"])
                else:
                    ref = (low, s["value_low"])
                s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                         high=hi[0], value_high=hi[1], slope_high=hi[2],
                         cubic_ref=ref[0], value_cubic_ref=ref[1])
                s["failed"] = (k + 1 >= max_steps
                               or (delta <= z["interval_threshold"]
                                   and s["safe_stepsize"] > 0.0)) \
                    and not s["done"]
            s.update(count=k + 1, stepsize=new, value=v, grad=g, slope=slope,
                     dec_err=dec)
            if s["failed"] and (s["safe_stepsize"] > 0.0
                                or np.isinf(s["dec_err"])):
                # the best step of sufficient decrease seen, or none at all
                # when even the first trial left the domain
                s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                         grad=s["safe_grad"])
    return s["stepsize"], s["value"], s["grad"]


def optimize_lbfgs(f, x_0, N_steps=100, f_min=1e-16, memory_size=10,
                   scale_init_precond=True):
    """L-BFGS (JAX ``optimize_lbfgs``, i.e. ``optax.lbfgs`` with its
    defaults), reporting reference-style histories.

    Each step preconditions the gradient by the two-loop recursion over the
    last ``memory_size`` parameter and gradient differences (the initial
    inverse Hessian a scaled identity: <dg, dx> / |dg|^2, and min(1,
    1/|g|) at the first step) and runs the zoom line search from stepsize
    1; the value and gradient at the accepted point are reused as the next
    step's (optax ``value_and_grad_from_state``).  A step records the
    iterate before its move; the run stops when f <= ``f_min`` (Converged)
    or f is not finite (Diverged).  ``memory_size`` and
    ``scale_init_precond`` are ``optax.lbfgs``'s keyword arguments, which
    the JAX function passes through (``scale_init_precond=False``: the
    identity at every step).
    """
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    vg = _value_and_grad(f)
    x = _host(x_0).copy()
    n = x.shape[0]
    m = int(memory_size)
    dW = np.zeros((m, n))
    dU = np.zeros((m, n))
    rhos = np.zeros(m)
    prev_x = np.zeros(n)
    prev_g = np.zeros(n)
    ls_value, ls_grad = np.inf, np.zeros(n)
    x_history, f_history, grad_history = [], [], []
    status = "Running"
    cur_f = None
    k = 0
    for k in range(N_steps):
        if np.isfinite(ls_value):
            cur_f, g = ls_value, ls_grad
        else:
            cur_f, g = vg(x)
        # the memory, updated with this step's differences (zero at the
        # first step)
        count = k
        mi, pmi = count % m, (count - 1) % m
        if count > 0:
            d_x, d_g = x - prev_x, g - prev_g
            vd = float(np.dot(d_g, d_x))
            weight = 0.0 if vd == 0.0 else 1.0 / vd
        else:
            d_x, d_g, weight = np.zeros(n), np.zeros(n), 0.0
        dW[pmi], dU[pmi], rhos[pmi] = d_x, d_g, weight
        if not scale_init_precond:
            gamma = 1.0
        elif count == 0:
            gnorm = float(np.sqrt(np.dot(g, g)))
            gamma = min(1.0, 1.0 / gnorm) if gnorm > 0 else 1.0
        else:
            den = float(np.dot(d_g, d_g))
            gamma = float(np.dot(d_g, d_x)) / den if den > 0.0 else 1.0
        # two-loop recursion, newest difference first
        order = (mi + np.arange(m)) % m
        vec = g.copy()
        alphas = np.zeros(m)
        for pos in range(m - 1, -1, -1):
            i = order[pos]
            alphas[pos] = rhos[i] * np.dot(dW[i], vec)
            vec = vec + (-alphas[pos]) * dU[i]
        vec = gamma * vec
        for pos in range(m):
            i = order[pos]
            beta = rhos[i] * np.dot(dU[i], vec)
            vec = vec + (alphas[pos] - beta) * dW[i]
        prev_x, prev_g = x, g
        upd = -vec
        step, ls_value, ls_grad = _zoom_linesearch(vg, x, upd, cur_f, g)
        x_history.append(x)
        f_history.append(cur_f)
        grad_history.append(g)
        x = x + step * upd
        if cur_f <= f_min:
            status = "Converged"
            break
        if not np.isfinite(cur_f):
            status = "Diverged"
            break

    return optResult(x, cur_f, f_history, x_history, grad_history, k, status)
