"""First-order local optimizers as host loops (port of the JAX package's
``optimize/local.py``).

The JAX package compiles each optimizer's whole run into one ``lax.scan``
and freezes the state once a terminal condition fires; here the same
iteration runs as a Python loop over the objective's value and gradient
(one primal and one adjoint sweep a step for a framework loss) and stops
at the terminal step.  The iterates, the histories, ``niter`` and the
status strings are the scan's: ``_finish`` slices the per-step records at
the first terminal code exactly as the JAX package does.

Objectives come in two flavours:

* framework losses (``Problem.getLossFunction``) and anything else with a
  ``value_and_grad(x) -> (value, gradient)``;
* plain callables ``f(x) -> scalar`` on f64 torch tensors, differentiated
  by autograd (analytic tests, user code).

The trust-region optimizer (``optimize_trust_region``) runs the same way
over the objective's quadratic model (``get_model_newt``: a framework
loss's ``value_grad_hessian``, else forward-over-reverse autograd), its
subproblem solved on the host in f64 by the spectral More-Sorensen
iteration of ``solve_trust_region_model``.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Callable

import numpy as np
import torch

optResult = namedtuple(
    "optResult",
    ["x", "f", "f_history", "x_history", "grad_history", "niter", "status"],
)

# terminal codes of a step (the JAX package's scan codes)
_RUNNING, _CONVERGED, _STALLED, _MODEL_FAIL = 0, 1, 2, 3
_STATUS = {
    _RUNNING: "Running",
    _CONVERGED: "Converged",
    _STALLED: "Stalled",
    _MODEL_FAIL: "Trust-region model solve produced an invalid step",
}


def _host(v) -> np.ndarray:
    """f64 numpy copy of a tensor on any device or an array-like."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def _value_and_grad(f: Callable):
    """``x (numpy) -> (value, gradient)`` as f64 numpy: the objective's own
    ``value_and_grad`` where it has one, else autograd through ``f``."""
    if hasattr(f, "value_and_grad"):
        def vg(x):
            v, g = f.value_and_grad(x)
            return _host(v)[()], _host(g)
        return vg

    def vg(x):
        xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        v = f(xt)
        (g,) = torch.autograd.grad(v, xt)
        return _host(v)[()], _host(g)
    return vg


def _value(f: Callable):
    """``x (numpy) -> value`` as an f64 numpy scalar."""
    def value(x):
        with torch.no_grad():
            return _host(f(torch.as_tensor(x, dtype=torch.float64)))[()]
    return value


class FixedParameterFunction:
    """View of an objective with a subset of coordinates pinned.

    ``FixedParameterFunction(f, n, idx, vals)`` behaves as
    ``g(y) = f(embed(y))`` where ``embed`` scatters the free coordinates
    ``y`` into an n-vector holding ``vals`` at ``idx``.  Differentiable
    through autograd for a plain ``f``; for an objective with its own
    ``value_and_grad`` (a framework loss) ``value_and_grad`` restricts that
    gradient to the free coordinates.
    """

    def __init__(self, function: Callable, param_size: int,
                 fixed_indices, fixed_values):
        self.func = function
        pinned_idx = np.atleast_1d(np.asarray(fixed_indices, dtype=np.int64))
        pinned_val = np.atleast_1d(np.asarray(fixed_values, dtype=np.float64))
        if pinned_idx.shape != pinned_val.shape:
            raise ValueError(
                f"{pinned_idx.size} pinned indices vs {pinned_val.size} values"
            )
        template = np.zeros(param_size)
        template[pinned_idx] = pinned_val
        free = np.setdiff1d(np.arange(param_size), pinned_idx)
        self.array = template
        self.free_idx = free

    def _embed(self, params):
        params = torch.as_tensor(params, dtype=torch.float64)
        full = torch.as_tensor(self.array, device=params.device).clone()
        full[torch.as_tensor(self.free_idx, device=params.device)] = params
        return full

    def __call__(self, params, *args):
        return self.func(self._embed(params), *args)

    def value_and_grad(self, params):
        if hasattr(self.func, "value_and_grad"):
            v, g = self.func.value_and_grad(self._embed(params))
            return v, g[torch.as_tensor(self.free_idx, device=g.device)]
        y = torch.tensor(_host(params), requires_grad=True)
        v = self(y)
        (g,) = torch.autograd.grad(v, y)
        return v.detach(), g


def _finish(x_fin, xs, fs, gs, codes, outer_of):
    """Slice the per-step records at the first terminal entry and package
    the reference-shaped result record (JAX ``_finish``).

    ``codes[t]``: terminal code raised at entry t (0 while running).  A
    ``_MODEL_FAIL`` entry is left out of the histories (the failing step
    never produced a valid iterate); other terminal entries are included.
    ``outer_of(t)`` maps a history index to the reported iteration count
    (identity for per-step optimizers, ``t // n`` for coordinate cycles).
    """
    codes = np.asarray(codes, dtype=np.int64)
    hit = np.flatnonzero(codes != _RUNNING)
    if hit.size:
        t = int(hit[0])
        code = int(codes[t])
        last = t - 1 if code == _MODEL_FAIL else t
    else:
        t = codes.shape[0] - 1
        code = _RUNNING
        last = t
    return optResult(x_fin, fs[last] if last >= 0 else None,
                     list(fs[:last + 1]), list(xs[:last + 1]),
                     list(gs[:last + 1]), outer_of(t), _STATUS[code])


# ---------------------------------------------------------------------------
# trust region
# ---------------------------------------------------------------------------

def solve_trust_region_model(B, g, delta, rtol=1e-6, max_iter=100):
    """Minimize ``g.p + p.B.p/2`` subject to ``||p|| <= delta`` (JAX
    ``solve_trust_region_model``), on the host in f64.

    Spectral More-Sorensen: with ``B = Q diag(w) Q^T`` and ``c = Q^T g``,
    the constrained minimizer is ``p(lam) = -Q ((w+lam)^-1 c)`` for the
    unique ``lam >= max(0, -w_min)`` with ``||p(lam)|| = delta`` (or
    ``lam = 0`` when the Newton point is interior).  The root is found by
    ``max_iter`` safeguarded Newton steps on the secular function
    ``1/||p(lam)|| - 1/delta``; the hard case (gradient orthogonal to the
    most-negative eigendirection) is completed with an explicit
    eigenvector component.  Returns ``(p, lam, predicted_decrease)``.
    """
    B = _host(B)
    g = _host(g)
    eps = np.finfo(np.float64).eps
    ftiny = np.finfo(np.float64).tiny
    w, Q = np.linalg.eigh(0.5 * (B + B.T))
    c = Q.T @ g
    w_min = w[0]
    scale = max(np.max(np.abs(w)), 1.0)
    tiny = eps * scale

    # interior Newton point: valid iff B is PD and the step fits the radius
    d_int = np.where(np.abs(w) < tiny, tiny, w)
    p_int = -c / d_int
    interior = bool(w_min > tiny) and bool(np.linalg.norm(p_int) <= delta)

    # boundary root: lam in (lam_floor, ||c||/delta - w_min]
    lam_floor = max(-w_min, 0.0)
    lam_cap = max(np.linalg.norm(c) / max(delta, tiny) - w_min,
                  lam_floor + scale)
    lam, lo, hi = lam_floor + 0.5 * (lam_cap - lam_floor), lam_floor, lam_cap
    # a NaN or infinite Newton proposal (a vanishing ||p||) fails the
    # bracket test and bisects, as in the JAX package's compiled loop
    with np.errstate(all="ignore"):
        for _ in range(int(max_iter) if max_iter else 40):
            d = np.maximum(w + lam, tiny)
            y = c / d
            nrm = max(np.linalg.norm(y), ftiny)
            phi = 1.0 / nrm - 1.0 / delta
            dphi = np.sum(y * y / d) / nrm**3
            if nrm > delta:
                lo = max(lo, lam)
            if nrm <= delta:
                hi = min(hi, lam)
            prop = lam - phi / max(dphi, ftiny)
            lam = prop if lo < prop < hi else 0.5 * (lo + hi)

    lam = 0.0 if interior else max(lam, lam_floor + tiny)
    d = d_int if interior else np.maximum(w + lam, tiny)
    y = -c / d

    # hard case: the boundary iteration bottomed out at lam ~ -w_min with
    # ||p|| still short of the radius; fill the gap along the bottom
    # eigenvector (any sign attains the same model value)
    gap2 = max(delta**2 - np.sum(y * y), 0.0)
    if not interior and np.linalg.norm(y) < delta * (1.0 - 10 * rtol):
        y[0] += np.sqrt(gap2)

    # never overshoot the radius (finite secular iterations leave slack)
    nrm = np.linalg.norm(y)
    if nrm > delta:
        y = y * (delta / max(nrm, tiny))

    p = Q @ y
    decrease = -(np.dot(c, y) + 0.5 * np.sum(w * y * y))
    return p, lam, decrease


def get_model_newt(f):
    """Quadratic-model oracle ``x -> (f, grad, dense Hessian)`` as f64
    numpy: the objective's own ``value_grad_hessian`` when it has one (a
    framework loss: four sweeps), else forward over reverse autograd
    through a plain torch function."""
    if hasattr(f, "value_grad_hessian"):
        def oracle(x):
            v, g, H = f.value_grad_hessian(x)
            return _host(v)[()], _host(g), _host(H)
        return oracle

    def oracle(x):
        xt = torch.as_tensor(_host(x))
        g, v = torch.func.grad_and_value(f)(xt)
        H = torch.func.jacfwd(torch.func.grad(f))(xt)
        return _host(v)[()], _host(g), _host(H)
    return oracle


def optimize_trust_region(f, x_0, N_steps=10, delta_max=1.0, delta=None,
                          eta=0.15, method="newt", steps_to_stall=10):
    """Trust-region Newton (JAX ``optimize_trust_region``) as a host loop.

    Radius policy: quarter the radius when the model over-promises
    (``rho < 1/4``), double it (capped at ``delta_max``) after a radius-
    limited accurate step (``rho >= 3/4`` on the boundary); accept iterates
    with ``rho >= eta``.  Rejected steps reuse the cached model — the
    Hessian oracle only runs after an accepted move.  A step records the
    iterate after its move with the model's value and gradient; the run
    stops at the first terminal code (converged at f < 1e-16, stalled after
    ``steps_to_stall`` rejections in a row, or an invalid model step).
    """
    if delta is None:
        delta = delta_max / 10.0
    if not 0.0 <= eta <= 0.25:
        raise ValueError(f"eta must lie in [0, 0.25]; got {eta}")
    if method != "newt":
        raise NotImplementedError(f"Method <<{method}>> not implemented")

    model = get_model_newt(f)
    value = _value(f)
    x = _host(x_0).copy()
    rad = float(delta)
    want_model, stall = True, 0
    v = g = H = None
    xs, fs, gs, codes = [], [], [], []
    for _ in range(N_steps):
        if want_model:
            v, g, H = model(x)
        p, lam, pred = solve_trust_region_model(H, g, rad)
        ok = bool(np.isfinite(pred)) and pred >= 0 and bool(
            np.all(np.isfinite(p)))
        if ok:
            v_trial = value(x + p)
            rho = (v - v_trial) / max(pred, np.finfo(np.float64).tiny)
            if rho < 0.25:
                rad = 0.25 * rad
            elif rho >= 0.75 and lam > 0:
                rad = min(2.0 * rad, delta_max)
        accept = ok and rho >= eta
        if accept:
            x = x + p
        stall = 0 if accept else stall + 1
        code = (_MODEL_FAIL if not ok else _CONVERGED if v < 1e-16
                else _STALLED if stall >= steps_to_stall else _RUNNING)
        xs.append(x)
        fs.append(v)
        gs.append(g)
        codes.append(code)
        if code != _RUNNING:
            break
        want_model = accept
    return _finish(x, xs, fs, gs, codes, lambda t: t)


# ---------------------------------------------------------------------------
# first-order methods
# ---------------------------------------------------------------------------

def optimize_gd(f, x_0, N_steps=100, h=0.01, f_min=1e-8):
    """Fixed-step gradient descent: x <- x - h grad f(x) until f(x) <=
    f_min (that step's record is the last) or N_steps records."""
    vg = _value_and_grad(f)
    x = _host(x_0).copy()
    xs, fs, gs, codes = [], [], [], []
    for _ in range(N_steps):
        v, g = vg(x)
        xs.append(x)
        fs.append(v)
        gs.append(g)
        codes.append(_CONVERGED if v <= f_min else _RUNNING)
        if codes[-1] != _RUNNING:
            break
        x = x - h * g
    return _finish(x, xs, fs, gs, codes, lambda t: t)


def _run_cd(f, x_0, N_steps, h, f_min, adaptive):
    """The coordinate-descent family: ``N_steps`` cycles over the ``n``
    coordinates, one record per coordinate visit.  ``adaptive`` adds a
    per-coordinate step-size register with one shrink-and-retry backtrack
    per visit (factor 5), the cd_mem2 policy."""
    vg = _value_and_grad(f)
    value = _value(f)
    x = _host(x_0).copy()
    n = x.shape[0]
    if n < 2:
        raise ValueError("coordinate descent needs at least 2 parameters")
    eye = np.eye(n)
    steps = np.full(n, h, dtype=np.float64)
    xs, fs, gs, codes = [], [], [], []
    for t in range(N_steps * n):
        i = t % n
        v, g = vg(x)
        g_i = eye[i] * g[i]
        xs.append(x)
        fs.append(v)
        gs.append(g_i)
        codes.append(_CONVERGED if v <= f_min else _RUNNING)
        if codes[-1] != _RUNNING:
            break
        if adaptive and value(x - steps[i] * g_i) > v:
            steps[i] = steps[i] / 5.0
        x = x - steps[i] * g_i
    return _finish(x, xs, fs, gs, codes, lambda t: t // n)


def optimize_cd(f, x_0, N_steps=100, h=0.01, f_min=1e-8):
    """Cyclic coordinate descent (single-coordinate gradient steps)."""
    return _run_cd(f, x_0, N_steps, h, f_min, adaptive=False)


def optimize_cd_mem(f, x_0, N_steps=100, h=0.01, f_min=1e-8):
    """Reference-parity alias of :func:`optimize_cd`: the reference's
    ``_mem`` variant re-derives each coordinate's gradient through a
    pinned-parameter wrapper to save autodiff memory (Optimizers.py:290-
    323); the coordinate updates are mathematically identical."""
    return _run_cd(f, x_0, N_steps, h, f_min, adaptive=False)


def optimize_cd_mem2(f, x_0, N_steps=100, h=0.01, f_min=1e-8):
    """Coordinate descent with per-coordinate adaptive steps: a visit whose
    update raises the objective retries once from the same iterate with
    that coordinate's step shrunk 5x (kept shrunk for later cycles)."""
    return _run_cd(f, x_0, N_steps, h, f_min, adaptive=True)
