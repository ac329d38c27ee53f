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

The trust-region optimizer and its model solve (``optimize_trust_region``,
``solve_trust_region_model``, ``get_model_newt``) need the loss Hessian and
are not ported yet (ROADMAP Queue 1, item D, second half).
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
_RUNNING, _CONVERGED, _STALLED = 0, 1, 2
_STATUS = {
    _RUNNING: "Running",
    _CONVERGED: "Converged",
    _STALLED: "Stalled",
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

    ``codes[t]``: terminal code raised at entry t (0 while running); the
    terminal entry is included in the histories.
    ``outer_of(t)`` maps a history index to the reported iteration count
    (identity for per-step optimizers, ``t // n`` for coordinate cycles).
    """
    codes = np.asarray(codes, dtype=np.int64)
    hit = np.flatnonzero(codes != _RUNNING)
    if hit.size:
        t = int(hit[0])
        code = int(codes[t])
    else:
        t = codes.shape[0] - 1
        code = _RUNNING
    return optResult(x_fin, fs[t] if t >= 0 else None, list(fs[:t + 1]),
                     list(xs[:t + 1]), list(gs[:t + 1]), outer_of(t),
                     _STATUS[code])


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
