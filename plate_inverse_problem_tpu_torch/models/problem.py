"""Problem: geometry + material + accelerometer -> FRF sweep on a device.

Port of the JAX package's ``models/problem.py`` with its three engines —
mixed (the default: band Rayleigh-Ritz start and preconditioned FGMRES),
modal (one generalized eigh per parameter set) and direct (chunked dense
LU) — on both of its paths: the 3-field (laminate) path with the
accelerometer-disk readout, and the symmetric pure-bending path (a
mid-plane symmetric material and no accelerometer) with its complex
test-point readout.  The mixed engine has three tiers: the flat f64
operator with the dense preconditioner (n < 8192), the RCM
block-tridiagonal f64 operator with the dense preconditioner (8192 <= n <=
12288) or with the two-grid f32 preconditioner (n > 12288); on request
(``precond="mg"`` on the flat layout) the flat multilevel preconditioner,
and (``basis="lobpcg"``) the band basis by LOBPCG on the device instead
of ARPACK on the host.  Every
material family runs, per-modulus loss factors included; a material whose
transform depends on the frequency runs through the direct engine (any
other engine warns and falls back to it, as in the JAX package).  The
three engines share the operator data, the coefficient chain, the
right-hand side, the residual map through K3 and the readouts, and differ
only in their solve.  Operator data is a plain dict of tensors under the
JAX opdata's key names; ``getFRCore`` returns a plain function of (freqs,
params, opdata).  ``Problem(spath=...)`` reads a ``setup.json`` folder,
whose geometry may be a template, a FreeFEM ``.edp`` script or a ``.msh``
mesh.  ``diagnoseSweep`` returns the mixed sweep's per-frequency
convergence signal; ``solveInverse`` runs Gauss-Newton, trust region,
Newton, L-BFGS, gradient and coordinate descent and scipy's global
optimizers, on a compressed reference FRF if asked; ``getModePicture``
draws the deflection shape at one frequency from a host LU solve;
``solveForward(polish_peaks=...)`` corrects the scanned resonance peaks by
one exact host residual (``diagnostics.oracle.polish_peaks``).
"""
from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import Callable

import numpy as np
import torch

from ..config import F32
from ..fem.assembly import (
    MODULI_INDICES,
    _uvw_constraints,
    _w_constraints,
    accel_indicator,
    assemble_symm,
    assemble_unsymm,
)
from ..io.report import default_uid, write_log, write_report
from ..optimize import optResult
from ..utils.paths import get_repo_dir
from .accelerometer import Accelerometer, AccelerometerParams
from .geometry import Geometry, GeometryParams
from .materials import Material, get_material


def _numpy(x) -> np.ndarray:
    """numpy copy of a tensor on any device, or ``np.asarray`` of x."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _split_ref(reference_fr, device) -> torch.Tensor:
    """The reference FRF as an (F, 2) (re, im) f64 stack on ``device``;
    real references get a zero imaginary lane, so every loss and residual
    kind sees one layout."""
    r = _numpy(reference_fr)
    if np.iscomplexobj(r):
        r = np.stack([r.real, r.imag], axis=-1)
    else:
        r = np.stack([r, np.zeros_like(r)], axis=-1)
    return torch.as_tensor(r.astype(np.float64), device=device)


def _re_im(fr):
    """(Re fr, Im fr): the symmetric path's FRF is complex, the 3-field
    path's a real magnitude (Im fr = 0)."""
    if fr.is_complex():
        return fr.real, fr.imag
    return fr, torch.zeros_like(fr)


def _ref_abs2(ref):
    """|ref|^2 from the split (re, im) layout."""
    return ref[..., 0] ** 2 + ref[..., 1] ** 2


def _ref_abs(ref):
    """|ref| from the split (re, im) layout (``hypot``: no under/overflow
    of the square for |ref| beyond ~1e+-154)."""
    return torch.hypot(ref[..., 0], ref[..., 1])


def _as_tensor(x, device) -> torch.Tensor:
    """f64 tensor on ``device`` from a tensor or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.array(x, np.float64), device=device)


# core attributes the adjoint Gauss-Newton Jacobian needs (primal / adjoint
# sweeps, the explicit residual map, the solve-free readout): one predicate
# for every adjoint-mode selector
_ADJOINT_HOOKS = ("sweep_u", "sweep_adj", "apply_res", "readout_ui")


def _has_adjoint_hooks(core) -> bool:
    """Whether ``jac_mode='adjoint'`` takes ``core``: the JAX package's
    mixed-engine cores expose the adjoint hooks, its modal and direct cores
    do not.  Every port core carries the hooks (the implicit rules of the
    gradient and the forward mode run through them), so its ``engine``
    answers for the public predicate."""
    return (getattr(core, "engine", "mixed") == "mixed"
            and all(hasattr(core, a) for a in _ADJOINT_HOOKS))


# what the forward-mode r + J holds across its sweeps (the primal and
# tangent solutions, their right-hand sides, jacfwd's batched outputs), in
# f64 n-vectors a lane: 9.1 (isotropic, p = 3) and 12.5 (OrthotropicD4,
# p = 8) at n = 20916 over 128-4608 lanes (.probes/fwd_chunk_probe.py on an
# NVIDIA H100 80GB HBM3, 700.00 W), with room
_FWD_HELD_VECS = 16.0


def _fwd_budget(device: torch.device) -> float:
    """Bytes the forward-mode r + J may hold across its sweeps: a quarter of
    the card's memory (the rest is the operator's, the sweep's own chunk's
    and the caller's), the JAX package's 2 GB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 4.0
    return 2.0e9


class _LaneSolve(torch.autograd.Function):
    """X = A(theta)^-1 B for right-hand sides B (L, n), lane i at frequency
    ``freqs[i]`` (``core.sweep_rhs``): the tangent solve of the forward
    mode, not differentiable itself.  Its ``vmap`` rule folds a batch of
    right-hand sides (the p tangents of ``jacfwd``) into the lanes of ONE
    sweep, with the frequencies repeated, instead of p sweeps."""

    @staticmethod
    def forward(B_re, B_im, params, freqs, od, core):
        return core.sweep_rhs(freqs, params, od, B_re, B_im)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, B_re, B_im, params, freqs, od, core):
        if in_dims[2] is not None or in_dims[3] is not None:
            raise NotImplementedError(
                "_LaneSolve batches right-hand sides, not operators.")
        nb = info.batch_size

        def lanes(b, d):
            b = b.movedim(d, 0) if d is not None else b.expand(nb, *b.shape)
            return b.reshape(-1, b.shape[-1])

        X_re, X_im = _LaneSolve.apply(lanes(B_re, in_dims[0]),
                                      lanes(B_im, in_dims[1]), params,
                                      freqs.repeat(nb), od, core)
        shape = (nb, freqs.shape[0], X_re.shape[-1])
        return (X_re.reshape(shape), X_im.reshape(shape)), (0, 0)


class _ImplicitSweep(torch.autograd.Function):
    """U(theta) = A(theta)^-1 b(theta) with the adjoint backward and the
    forward-mode rule — the role ``lax.custom_linear_solve`` plays in the
    JAX package, under ``torch.autograd`` and ``torch.func`` alike.

    Forward: the primal sweep, outside the graph.  Backward, for the
    cotangent G = dL/dU: one adjoint sweep conj(A) Y = G, then
    dL/dtheta = -d/dtheta [sum Y . (A(theta) U - b(theta))] at fixed U and
    Y, by autograd through the solve-free residual map.  Forward mode, for
    the tangent d theta: dU = A^-1 (db - dA U), the right-hand side a
    forward tangent of the residual map at fixed U (K3's data tangents),
    the solve ``_LaneSolve`` — so ``jacfwd`` runs ONE sweep over its p x F
    tangent lanes beside the shared primal.  A lane whose right-hand side
    is all zero (a parameter that does not reach it) stays zero."""

    @staticmethod
    def forward(params, freqs, od, core):
        return core.sweep_u(freqs, params, od)

    @staticmethod
    def setup_context(ctx, inputs, output):
        params, freqs, od, core = inputs
        U_re, U_im = output
        ctx.core, ctx.freqs, ctx.od = core, freqs, od
        ctx.save_for_backward(params, U_re, U_im)
        ctx.save_for_forward(params, U_re, U_im)

    @staticmethod
    def backward(ctx, g_re, g_im):
        params, U_re, U_im = ctx.saved_tensors
        core, freqs, od = ctx.core, ctx.freqs, ctx.od
        th = params.detach()
        Y_re, Y_im = core.sweep_adj(freqs, th, od, g_re, g_im)
        with torch.enable_grad():
            th = th.requires_grad_(True)
            R_re, R_im = core.apply_res(freqs, th, od, U_re.detach(),
                                        U_im.detach())
            psi = (Y_re * R_re).sum() + (Y_im * R_im).sum()
            (g,) = torch.autograd.grad(psi, th)
        return -g, None, None, None

    @staticmethod
    def jvp(ctx, d_params, _d_freqs, _d_od, _d_core):
        params, U_re, U_im = ctx.saved_tensors
        core, freqs, od = ctx.core, ctx.freqs, ctx.od
        _, (dR_re, dR_im) = torch.func.jvp(
            lambda th: core.apply_res(freqs, th, od, U_re, U_im),
            (params,), (d_params,))
        return _LaneSolve.apply(-dR_re, -dR_im, params, freqs, od, core)

    @staticmethod
    def vmap(info, in_dims, params, freqs, od, core):
        # a batch of parameter vectors is a batch of operators: one sweep
        # each
        if in_dims[1] is not None:
            raise NotImplementedError("_ImplicitSweep batches parameter "
                                      "vectors, not frequency grids.")
        outs = [_ImplicitSweep.apply(th, freqs, od, core)
                for th in params.movedim(in_dims[0], 0)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)


class LossFunction:
    """Scalar loss of the FRF against a reference: ``f(params) -> scalar``
    with ``value_and_grad``, ``grad``, ``hessian`` and
    ``value_grad_hessian`` (JAX ``LossFunction``).

    Types MSE / RMSE / MSE_AFC / MSE_LOG_AFC, each the mean of a
    per-frequency term.  The gradient costs one primal and one adjoint
    sweep (``_ImplicitSweep``), the Hessian two more sweeps of p x F lanes
    (``value_grad_hessian``).  Values and derivatives are f64 tensors on
    the operator data's device.
    """

    def __init__(self, core, opdata, frequencies, reference_fr, func_type,
                 scaling_params=None):
        dev = opdata["rows"].device
        self._core = core
        self._opdata = opdata
        self._device = dev
        self._freqs = _as_tensor(frequencies, dev)
        self._ref = _split_ref(reference_fr, dev)
        self.func_type = func_type
        self._scaling = (1.0 if scaling_params is None
                         else _as_tensor(scaling_params, dev))

        if func_type == "MSE":
            def term(fr, ref):
                re, im = _re_im(fr)
                return (re - ref[..., 0]) ** 2 + (im - ref[..., 1]) ** 2
        elif func_type == "RMSE":
            def term(fr, ref):
                re, im = _re_im(fr)
                return (((re - ref[..., 0]) ** 2 + (im - ref[..., 1]) ** 2)
                        / _ref_abs2(ref))
        elif func_type == "MSE_AFC":
            def term(fr, ref):
                return (torch.abs(fr) - _ref_abs(ref)) ** 2
        elif func_type == "MSE_LOG_AFC":
            def term(fr, ref):
                return (torch.log(torch.abs(fr))
                        - torch.log(_ref_abs(ref))) ** 2
        else:
            raise ValueError(f'Function type "{func_type}" is not supported!')
        self._term = term

    def _full(self, params):
        fr = self._core(self._freqs, params * self._scaling, self._opdata)
        return self._term(fr, self._ref).mean()

    def __call__(self, params):
        with torch.no_grad():
            return self._full(_as_tensor(params, self._device))

    def value_and_grad(self, params):
        th = _as_tensor(params, self._device).detach().requires_grad_(True)
        v = self._full(th)
        (g,) = torch.autograd.grad(v, th)
        return v.detach(), g

    def grad(self, params):
        return self.value_and_grad(params)[1]

    def hessian(self, params):
        return self.value_grad_hessian(params)[2]

    def value_grad_hessian(self, params):
        """(f, gradient, dense Hessian): the trust-region and Newton model
        oracle (JAX ``jacfwd(grad)`` through the linear solve), as an
        explicit second-order adjoint with the p tangents batched as lanes.

        With R(theta, U) = A(theta) U - b(theta), the loss l(U), its
        gradient G = dl/dU and <a, b> the real (re, im) pairing:

        * the primal sweep U and the adjoint sweep conj(A) Y = G;
        * dR_i = d/dtheta_i R(theta, U) at fixed U (K3's data tangents), so
          g_i = -<Y, dR_i>;
        * ONE tangent sweep over p x F lanes: A dU_i = -dR_i;
        * ONE adjoint sweep over p x F lanes: conj(A) dY_i = (d^2l/dU^2)
          dU_i - Q_i, Q_i = d/dtheta_i (conj(A(theta)) Y) at fixed Y (the
          term (dA)^H Y);
        * H_ij = -<dY_j, dR_i> - <Q_i, dU_j> - d^2/dtheta_i dtheta_j <Y,
          R(theta, U)> at fixed U and Y, the last by forward over reverse
          mode through the solve-free residual map (K3's data gradient).

        Four sweeps; no derivative runs through the FGMRES loop.  Values
        are f64 tensors on the operator data's device; H is not
        symmetrised (its asymmetry is the tangent solves' own error)."""
        core, od, freqs = self._core, self._opdata, self._freqs
        x = _as_tensor(params, self._device).detach()
        sc = self._scaling
        th = x * sc
        p, F = x.shape[0], freqs.shape[0]
        fr_rep = freqs.repeat(p)

        def ell(U_re, U_im):
            return self._term(core.readout_ui(U_re, U_im, od),
                              self._ref).mean()

        grad_ell = torch.func.grad_and_value(ell, argnums=(0, 1))
        U_re, U_im = core.sweep_u(freqs, th, od)
        (G_re, G_im), v = grad_ell(U_re, U_im)
        Y_re, Y_im = core.sweep_adj(freqs, th, od, G_re, G_im)
        basis = torch.eye(p, dtype=x.dtype, device=x.device)

        def tangents(fn):
            """(p, L, n) pairs: d/dx_i fn(x) for every i, in one K3 pass
            over the folded operator stack."""
            return torch.func.vmap(
                lambda e: torch.func.jvp(fn, (x,), (e,))[1])(basis)

        dR_re, dR_im = tangents(
            lambda xx: core.apply_res(freqs, xx * sc, od, U_re, U_im))
        g = -((Y_re * dR_re).sum((1, 2)) + (Y_im * dR_im).sum((1, 2)))

        dU_re, dU_im = (t.reshape(p, F, -1) for t in core.sweep_rhs(
            fr_rep, th, od, -dR_re.reshape(p * F, -1),
            -dR_im.reshape(p * F, -1)))
        dG_re, dG_im = torch.func.vmap(
            lambda a, b: torch.func.jvp(lambda ur, ui: grad_ell(ur, ui)[0],
                                        (U_re, U_im), (a, b))[1]
        )(dU_re, dU_im)
        Q_re, Q_im = tangents(
            lambda xx: core.apply_op(freqs, xx * sc, od, Y_re, Y_im,
                                     adjoint=True))
        dY_re, dY_im = (t.reshape(p, F, -1) for t in core.sweep_adj(
            fr_rep, th, od, (dG_re - Q_re).reshape(p * F, -1),
            (dG_im - Q_im).reshape(p * F, -1)))

        def psi(xx):
            R_re, R_im = core.apply_res(freqs, xx * sc, od, U_re, U_im)
            return (Y_re * R_re).sum() + (Y_im * R_im).sum()

        def pair(a_re, a_im, b_re, b_im):
            return (torch.einsum("ifn,jfn->ij", a_re, b_re)
                    + torch.einsum("ifn,jfn->ij", a_im, b_im))

        H = -(pair(dR_re, dR_im, dY_re, dY_im)
              + pair(Q_re, Q_im, dU_re, dU_im)
              + torch.func.jacfwd(torch.func.grad(psi))(x))
        return v.detach(), g.detach(), H.detach()


class ResidualFunction:
    """Vector residual r(theta) with its Jacobian for Gauss-Newton (JAX
    ``ResidualFunction``).

    kinds: 'log_afc' (r_i = log|fr_i| - log|ref_i|, the Gauss-Newton
    counterpart of MSE_LOG_AFC), 'afc' (|fr| - |ref|) and 'complex' (the
    stacked re/im of fr - ref, 2F rows).

    Jacobian modes (``jac_mode``):

    * 'adjoint' — each row is a per-frequency scalar, so J costs two
      batched sweeps — the primal and one adjoint sweep conj(A_i) y_i =
      dr_i/dU_i — plus p forward tangents of the solve-free residual map
      psi_i(theta) = y_i . (A_i(theta) U_i - b_i(theta)), J = -dpsi/dtheta,
      whatever the parameter count p.  Scalar kinds only.
    * 'fwd' — the fused value-and-``jacfwd``: the primal sweep and ONE
      tangent sweep over p x F lanes (``_ImplicitSweep``'s forward rule),
      every kind.  ``freq_chunk`` runs it over blocks of that many
      frequencies (the last block padded by repeating the last frequency),
      bounding the state held across the sweeps; a chunk of F or more is
      one block of the F frequencies.
    * 'auto' — 'adjoint' for the scalar kinds, 'fwd' for 'complex'.

    r and J are f64 tensors on the operator data's device.
    """

    def __init__(self, core, opdata, frequencies, reference_fr, kind="log_afc",
                 scaling_params=None, freq_chunk: int | None = None,
                 jac_mode: str = "auto"):
        if kind == "log_afc":
            def resid(fr, ref):
                return torch.log(torch.abs(fr)) - torch.log(_ref_abs(ref))
        elif kind == "afc":
            def resid(fr, ref):
                return torch.abs(fr) - _ref_abs(ref)
        elif kind == "complex":
            def resid(fr, ref):
                re, im = _re_im(fr)
                return torch.cat([re - ref[..., 0], im - ref[..., 1]])
        else:
            raise ValueError(f"Unknown residual kind {kind!r}.")
        if freq_chunk is not None and kind == "complex":
            raise ValueError(
                "freq_chunk is only supported for per-frequency scalar "
                "residual kinds ('log_afc', 'afc').")
        adjoint_ok = kind in ("log_afc", "afc") and _has_adjoint_hooks(core)
        if jac_mode == "auto":
            jac_mode = "adjoint" if adjoint_ok else "fwd"
        elif jac_mode == "adjoint" and not adjoint_ok:
            raise ValueError(
                "jac_mode='adjoint' needs a per-frequency scalar residual "
                "kind ('log_afc'/'afc') and an engine exposing the adjoint "
                "hooks (mixed engine cores do).")
        elif jac_mode not in ("adjoint", "fwd"):
            raise ValueError(f"Unknown jac_mode {jac_mode!r}.")
        if jac_mode == "adjoint" and freq_chunk is not None:
            # the adjoint r + J never holds per-parameter solution batches,
            # so the chunk has nothing to bound there; honouring it silently
            # as a no-op would hide a caller's intent to cap memory
            warnings.warn(
                "freq_chunk only bounds the jacfwd Jacobian; the adjoint "
                "jac_mode ignores it (memory is bounded by the engine's "
                "sweep/apply chunking). Pass jac_mode='fwd' to chunk, or "
                "drop freq_chunk.", RuntimeWarning, stacklevel=3)
            freq_chunk = None
        dev = opdata["rows"].device
        self._core = core
        self._opdata = opdata
        self._device = dev
        self._freqs = _as_tensor(frequencies, dev)
        self._ref = _split_ref(reference_fr, dev)
        self._scaling = (1.0 if scaling_params is None
                         else _as_tensor(scaling_params, dev))
        self._resid = resid
        self._chunk = freq_chunk
        self.kind = kind
        self.jac_mode = jac_mode

    def _full(self, params, freqs, ref):
        fr = self._core(freqs, params * self._scaling, self._opdata)
        return self._resid(fr, ref)

    def __call__(self, params):
        th = _as_tensor(params, self._device)
        with torch.no_grad():
            return self._full(th, self._freqs, self._ref)

    def value_and_jac(self, params):
        params = _as_tensor(params, self._device)
        if self.jac_mode == "adjoint":
            return self._rj_adjoint(params)
        F = self._freqs.shape[0]
        if self._chunk is None or self._chunk >= F:
            return self._rj_fwd(params, self._freqs, self._ref)
        # every block the same size: the last one repeats the last
        # frequency, and its copies are cut off
        c = int(self._chunk)
        pad = -F % c
        fpad = torch.cat([self._freqs, self._freqs[-1:].repeat(pad)])
        rpad = torch.cat([self._ref, self._ref[-1:].repeat(pad, 1)])
        rs, Js = zip(*(self._rj_fwd(params, fpad[lo:lo + c], rpad[lo:lo + c])
                       for lo in range(0, F + pad, c)))
        return torch.cat(rs)[:F], torch.cat(Js)[:F]

    def _rj_fwd(self, params, freqs, ref):
        """(r, J) on one block of frequencies: one primal sweep shared by
        the p tangents, whose solves run as one sweep of p x F lanes."""
        def f(th):
            r = self._full(th, freqs, ref)
            return r, r

        J, r = torch.func.jacfwd(f, has_aux=True)(params)
        return r.detach(), J.detach()

    def _rj_adjoint(self, params):
        core, od, freqs, ref = self._core, self._opdata, self._freqs, \
            self._ref
        th = params * self._scaling
        # U and Y are constants of the Jacobian formula (their theta-
        # derivatives are what the adjoint identity eliminates)
        U_re, U_im = core.sweep_u(freqs, th, od)
        # r(U) is per-frequency diagonal (row i depends only on U[i]), so
        # ONE pullback at the all-ones cotangent gives every row gradient
        # G_i = dr_i/dU_i
        with torch.enable_grad():
            Ur = U_re.detach().requires_grad_(True)
            Ui = U_im.detach().requires_grad_(True)
            r = self._resid(core.readout_ui(Ur, Ui, od), ref)
            G_re, G_im = torch.autograd.grad(r, (Ur, Ui),
                                             torch.ones_like(r))
        Y_re, Y_im = core.sweep_adj(freqs, th, od, G_re, G_im)

        def psi(p):
            R_re, R_im = core.apply_res(freqs, p * self._scaling, od,
                                        U_re, U_im)
            return (Y_re * R_re + Y_im * R_im).sum(-1)

        # dr_i = -y_i . d(A_i U_i - b_i): p forward tangents through the
        # scatter passes and the coefficient chain, no solve
        J = -torch.func.jacfwd(psi)(params)
        return r.detach(), J


class Problem:
    """Holds geometry/material/sensor data and the assembled FEM operators,
    and produces the FRF function on ``device`` (the card unless the
    caller asks for ``"cpu"``).

    With an accelerometer (or a material that is not mid-plane symmetric)
    the plate runs the 3-field path and its FRF is the real accelerometer
    magnitude; with ``accel=None`` and a mid-plane symmetric material it
    runs the pure-bending path and its FRF is the complex amplitude at the
    test point.  ``spath``: a setup folder (``setup.json``, and optional
    ``freqs.npy`` / ``amp.npy`` / ``phase.npy`` reference data), absolute
    or under the repository's ``setups/``; the geometry, material and
    accelerometer given as arguments take precedence over its entries.
    """

    def __init__(
        self,
        geometry: Geometry = None,
        material: Material = None,
        accel: Accelerometer = None,
        ref_fr: tuple[np.ndarray, np.ndarray] = None,
        *,
        cpu: int | None = 0,            # accepted for reference API
                                        # parity; unused
        ozaki: bool | None = None,      # the JAX package's TPU f64
                                        # emulation switch; accepted and
                                        # unused (IEEE f64 on the card)
        spath: str | os.PathLike = None,
        device: torch.device | str = "cuda",   # "cpu" on request
        engine: str | None = "mixed",   # 'mixed' | 'modal' | 'direct';
                                        # None: the JAX package's choice
                                        # for the device (_engine)
        chunk: int = 16,                # the direct engine's frequency
                                        # chunk (distinct frequencies
                                        # factored at once)
        n_modes: int | None = None,     # the modal engine's truncation
                                        # (None: the full basis)
        f_max: float = 600.0,           # band edge of the basis [Hz]
        n_refine: int = 16,             # TOTAL Krylov budget
        k_cycle: int | None = None,     # FGMRES cycle length (None = 8)
        refine_tol: float = 3e-7,       # residual target (tracks the
                                        # delivered FRF accuracy ~1:1)
        precond: str = "auto",          # 'dense' / 'mg' (the two-grid on
                                        # the band layout, the multilevel
                                        # on the flat); auto: dense up to
                                        # 12288 DOF
        mg_coarse_max: int = 11500,     # sets the coarsening factor
        freq_chunk: int | None = None,  # lanes per batch (None = auto)
        operator_layout: str = "auto",  # 'flat' / 'band'; auto: band from
                                        # 8192 DOF
        basis: str = "arpack",          # how the band basis is computed:
                                        # 'arpack' (host shift-invert) or
                                        # 'lobpcg' (on the device)
        basis_f32: bool | None = None,  # f32 Krylov basis storage (the
                                        # JAX package's on its dense tier;
                                        # None: f64 on every tier)
        opdata: dict | None = None,     # operator data to use instead of
                                        # building it (convert.py)
    ):
        if (geometry, accel, material, spath) == (None,) * 4:
            raise ValueError("Cannot create a Problem object without arguments.")
        if engine not in (None, "mixed", "modal", "direct"):
            raise ValueError(f"Unknown sweep engine {engine!r}; use "
                             "'modal'/'direct'/'mixed'.")
        if precond not in ("auto", "dense", "mg"):
            raise ValueError(f"Unknown precond {precond!r}; valid options: "
                             "'auto', 'dense', 'mg'.")
        if operator_layout not in ("auto", "flat", "band"):
            raise ValueError(f"Unknown operator_layout {operator_layout!r}; "
                             "valid options: 'auto', 'flat', 'band'.")
        if basis not in ("arpack", "lobpcg"):
            raise ValueError(f"Unknown basis {basis!r}; valid options: "
                             "'arpack', 'lobpcg'.")
        self.device = torch.device(device)
        self.engine = engine
        self.chunk = int(chunk)
        self.n_modes = n_modes
        self.f_max = f_max
        self.n_refine = n_refine
        self.k_cycle = k_cycle
        self.refine_tol = float(refine_tol)
        self.precond = precond
        self.mg_coarse_max = int(mg_coarse_max)
        self.freq_chunk = freq_chunk
        self.operator_layout = operator_layout
        self.basis = basis
        self.basis_f32 = basis_f32
        self._given_opdata = opdata

        self.accelerometer = accel
        self.material = material
        self.geometry = geometry
        if spath is None:
            if None in (geometry, material):
                raise ValueError(
                    "Cannot create a Problem object without `spath` argument "
                    "if any of `geometry`, `material` arguments is `None`.")
        else:
            self._load_setup(spath, geometry, material, accel)
        if self.material.has_params:
            self.parameters = self.material.get_parameters()
        else:
            warnings.warn(
                "Some elastic moduli of a material were not provided, solving "
                "forward problem as standalone will not be possible.",
                RuntimeWarning)
        if ref_fr is not None:
            self.reference_fr = ref_fr
        rho = self.material.density
        h = self.geometry.height
        mesh = self.geometry.get_mesh()
        self.mesh = mesh
        acc = self.accelerometer

        have_accel_disk = None not in (self.geometry.accel_x,
                                       self.geometry.accel_y,
                                       self.geometry.accel_r)
        indicator = (accel_indicator(self.geometry.accel_x,
                                     self.geometry.accel_y,
                                     self.geometry.accel_r)
                     if have_accel_disk else None)
        clamped = getattr(self.geometry, "clamped_labels", (1,))

        # inertia constants (physical form, reference Problem.py:361-374)
        self.I0 = h * rho
        self.I2 = rho * h**3 / 12.0
        if acc is not None:
            rho_corr = acc.mass / (np.pi * acc.radius**2) / acc.height
            self.I0Corr = acc.height * rho_corr
            self.I2Corr = rho_corr / 3.0 * (
                (h / 2.0 + acc.height) ** 3 - h**3 / 8.0)
        else:
            self.I0Corr = 0.0
            self.I2Corr = 0.0

        self.is_symmetric_path = self.material.is_mps and acc is None
        if self.is_symmetric_path:
            op = assemble_symm(mesh, self.geometry.test_point,
                               indicator=indicator, clamped_labels=clamped)
            # I0 M + I2 L == rho (M + e^2/3 L) h  (Problem.py:269-271)
            self.MInertia = self.I0 * op.M + self.I2 * op.L
            self.fInertia = self.I0 * op.fM + self.I2 * op.fL
        else:
            if not have_accel_disk:
                raise ValueError("The 3-field (unsymmetric) path needs an "
                                 "accelerometer disk position on the "
                                 "geometry.")
            if acc is None:
                raise ValueError(
                    "A material that is not mid-plane symmetric runs the "
                    "3-field path, whose FRF is the accelerometer readout: "
                    "give the Problem an accelerometer.")
            op = assemble_unsymm(
                mesh, (self.geometry.accel_x, self.geometry.accel_y),
                self.geometry.accel_r, indicator=indicator,
                clamped_labels=clamped)
            self.MInertia = (
                self.I0 * (op.mats["M11"] + op.mats["M22"] + op.mats["M33"])
                + self.I0Corr * (op.mats["M11C"] + op.mats["M22C"]
                                 + op.mats["M33C"])
                + self.I2 * op.mats["M33I2"]
                + self.I2Corr * op.mats["M33I2C"]
            )
            self.fInertia = (
                self.I0 * (op.lifts["M11"] + op.lifts["M22"] + op.lifts["M33"])
                + self.I0Corr * (op.lifts["M11C"] + op.lifts["M22C"]
                                 + op.lifts["M33C"])
                + self.I2 * op.lifts["M33I2"]
                + self.I2Corr * op.lifts["M33I2C"]
            )
        self.op = op
        self.n_free = op.n_free

    # ------------------------------------------------------------------

    def _load_setup(self, spath, geometry, material, accel):
        """setup.json folder loading (reference Problem.py:103-214)."""
        if not isinstance(spath, (str, os.PathLike)):
            raise TypeError(
                "Argument `spath` should have one of the following types: "
                f"str | os.PathLike, not {type(spath)}.")
        if not os.path.isabs(spath):
            spath = os.path.join(get_repo_dir(), "setups", spath)
        if not os.path.exists(spath):
            raise ValueError(f"Path of the setup {spath} does not exist.")
        if not os.path.isdir(spath):
            raise ValueError(f"Selected path {spath} is not a directory.")
        setup_fpath = os.path.join(spath, "setup.json")
        if not os.path.exists(setup_fpath):
            raise FileNotFoundError(
                f"`setup.json` file was not found in setup directory {spath}.")
        with open(setup_fpath, "r") as file:
            setup_params = json.load(file)

        if "accelerometer" in setup_params:
            nop = setup_params["accelerometer"]
            if isinstance(nop, str):
                self.accelerometer = Accelerometer(nop)
            elif isinstance(nop, dict):
                self.accelerometer = Accelerometer(AccelerometerParams(**nop))
            else:
                raise TypeError(
                    f"In file {setup_fpath} key `accelerometer` should have a "
                    "value with type `str` or `dict`.")
        if "material" in setup_params:
            nop = setup_params["material"]
            if isinstance(nop, (str, dict)):
                self.material = get_material(nop)
            else:
                raise TypeError(
                    f"In file {setup_fpath} key `material` should have a value "
                    "with type `str` or `dict`.")

        if material is not None:
            self.material = material
        if accel is not None:
            self.accelerometer = accel
        if geometry is not None:
            self.geometry = geometry
        elif "geometry" in setup_params:
            gdict = dict(setup_params["geometry"])
            # optional mesh-resolution keys
            g_ny = gdict.pop("ny", None)
            g_refine = gdict.pop("refine", 1.0)
            if "template" in gdict:
                templ = gdict.pop("template")
                self.geometry = Geometry(
                    templ, accelerometer=self.accelerometer,
                    params=GeometryParams(**gdict), ny=g_ny, refine=g_refine)
            elif "edp" in gdict or "msh" in gdict:
                gfile = gdict.pop("edp", None) or gdict.pop("msh", None)
                gdict.pop("msh", None)
                if not os.path.isabs(gfile):
                    gfile = os.path.join(spath, gfile)
                if "length" in gdict:
                    self.geometry = Geometry(
                        gfile, accelerometer=self.accelerometer,
                        params=GeometryParams(**gdict))
                else:
                    self.geometry = Geometry(
                        gfile, accelerometer=self.accelerometer,
                        height=gdict["height"])
            else:
                raise ValueError(
                    "Cannot create Geometry object, file "
                    f"{setup_fpath} should contain `template`, `edp` or `msh` "
                    "keyword inside `geometry`.")

        freq_file = os.path.join(spath, "freqs.npy")
        if os.path.exists(freq_file):
            freqs = np.load(freq_file)
            amp = np.load(os.path.join(spath, "amp.npy"))
            ph_path = os.path.join(spath, "phase.npy")
            phase = (np.load(ph_path) if os.path.exists(ph_path)
                     else np.zeros_like(amp))
            self.reference_fr = (freqs, amp * np.exp(1j * phase))

        if None in (self.accelerometer, self.geometry, self.material):
            raise RuntimeError(
                "One of the `geometry`, `accelerometer`, `materials` "
                "attributes was not provided in setup.json nor as an "
                "argument.")

    # ------------------------------------------------------------------

    def getFRCore(self):
        """(core, opdata): ``core(freqs, params, opdata)`` plus the
        operator dict on the Problem's device (built once)."""
        memo = getattr(self, "_fr_core_memo", None)
        if memo is None:
            memo = self._fr_core_memo = self._build_fr_core()
        return memo

    def _engine(self) -> str:
        """The requested engine, or for ``engine=None`` the JAX package's
        choice with the Problem's device in place of its backend: on the
        CPU the modal engine for a scalar loss factor and the direct engine
        for per-modulus loss factors (both exact in f64), on the card the
        mixed engine."""
        if self.engine is not None:
            return self.engine
        if self.device.type == "cpu":
            return "modal" if self.material.scalar_loss_factor else "direct"
        return "mixed"

    def _resolve_engine(self) -> str:
        """The engine ``getFRCore`` builds: the requested or default one
        after the frequency-dependent-material fallback (only the direct
        engine evaluates the material transform at each frequency)."""
        engine = self._engine()
        if engine != "direct" and self._transform_is_freq_dependent():
            return "direct"
        return engine

    def _build_fr_core(self):
        # a custom material may depend on omega (the reference evaluates
        # transform(theta, omega) at every frequency, Problem.py:397-399);
        # only the direct engine takes that: modal assumes a constant real
        # pencil and mixed builds its operator once per sweep
        engine = self._resolve_engine()
        if engine != self._engine():
            warnings.warn(
                f"Material transform is frequency-dependent; engine "
                f"{self._engine()!r} assumes a frequency-constant operator "
                f"— falling back to engine='direct'.", RuntimeWarning)
        freq_dep = (engine == "direct"
                    and self._transform_is_freq_dependent())
        op = self.op
        n = op.n_free
        # symmetric diagonal equilibration S = diag(1/sqrt(|K_ii(theta_ref)|))
        # folded into the static operator data
        diag_slots = np.nonzero(op.pattern.rows == op.pattern.cols)[0]
        diag_rows = op.pattern.rows[diag_slots]
        K_ref = self._reference_stiffness_flat()
        dvals = np.zeros(n)
        np.add.at(dvals, diag_rows, np.abs(K_ref[diag_slots]))
        dvals = np.where(dvals > 0, dvals, 1.0)
        scale_vec = 1.0 / np.sqrt(dvals)
        self._eq_scale = scale_vec
        ss = scale_vec[op.pattern.rows] * scale_vec[op.pattern.cols]
        if engine == "mixed":
            return self._mixed_core(K_ref, ss, scale_vec)
        return self._factor_core(engine, ss, scale_vec, freq_dep)

    def _transform_is_freq_dependent(self) -> bool:
        """Host probe: does the material's split transform depend on omega?
        The built-in families do not; a custom material may (the reference
        evaluates transform(theta, omega) at every frequency,
        Problem.py:397-399).  Skipped without known parameters."""
        theta = getattr(self, "parameters", None)
        if theta is None:
            return False
        th = torch.as_tensor(np.asarray(theta, np.float64))
        h = self.geometry.height
        leaves = []
        for om in (0.0, 1234.5):
            if self.is_symmetric_path:
                out = (self.material.d_split(th, h, om),)
            else:
                out = self.material.abd_split(th, h, om)
            leaves.append(np.concatenate(
                [_numpy(x).reshape(-1) for pair in out for x in pair]))
        return not np.allclose(leaves[0], leaves[1], rtol=1e-12, atol=0.0,
                               equal_nan=True)

    def _coarse_level(self, factor: float):
        """Mesh, free DOFs and constrained mask of the coarsened geometry —
        all the two-grid prolongation needs of the coarse level."""
        mesh = self.geometry.coarsened(factor).get_mesh()
        constraints = (_w_constraints if self.is_symmetric_path
                       else _uvw_constraints)
        constrained, _ = constraints(
            mesh, getattr(self.geometry, "clamped_labels", (1,)))
        return mesh, np.nonzero(~constrained)[0], constrained

    def _mg_chain(self, n: int) -> list:
        """The flat multilevel's prolongations, finest first (JAX
        problem.py:1244-1290): coarsened Problems built with
        ``engine="direct"``, the first factor aimed at ``mg_coarse_max``
        (n scales ~ factor^-2: one exact coarse level beats a deeper chain
        of approximate ones), each next one twice as coarse while the
        coarsest holds more than ``mg_coarse_max`` DOF (at most 8 levels);
        the chain stops where a level would hold under 60 DOF or stops
        shrinking."""
        from ..ops.mg import build_prolongation

        chain = []
        fine = self
        factor = max(2.0, float(np.sqrt(n / (0.62 * self.mg_coarse_max))))
        while ((not chain or fine.n_free > self.mg_coarse_max)
               and len(chain) < 8):
            cp = Problem(self.geometry.coarsened(factor), self.material,
                         self.accelerometer, engine="direct",
                         device=self.device)
            if cp.n_free >= fine.n_free or cp.n_free < 60:
                break
            chain.append(cp)
            fine = cp
            factor *= 2.0
        if not chain:
            raise ValueError(
                "precond='mg' could not build a coarser mesh level for this "
                f"geometry (n_free={n}); use precond='dense'.")
        Ps = []
        fine = self
        for cp in chain:
            Ps.append(build_prolongation(
                fine.mesh, cp.mesh, fine.op.free_idx, cp.op.free_idx,
                fine.op.constrained, cp.op.constrained,
                three_field=not self.is_symmetric_path))
            fine = cp
        return Ps

    def _mixed_core(self, K_ref: np.ndarray, ss: np.ndarray,
                    scale_vec: np.ndarray):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from ..ops.band import (
            build_band_layout, build_rect_band, flat_to_band,
            permute_pattern, permute_vector, rect_band_tensor,
        )
        from ..ops.band_kernel import pack_band_tiles
        from ..ops.csr_kernel import build_csr
        from ..ops.dense import inv_refined
        from ..ops.lobpcg import band_basis_lobpcg
        from ..ops.mg import (
            _dinv_lmax, _pin_dead, build_multilevel_host, build_prolongation,
            multilevel_to_device,
        )
        from ..ops.mixed import band_basis_host, mixed_sweep
        from ..ops.scatter import to_dense

        op = self.op
        n = op.n_free
        dev = self.device
        symmetric = self.is_symmetric_path

        # the RCM block-tridiagonal layout from 8192 DOF (below it the dense
        # GEMM preconditioner dominates and the band's blocks are tiny);
        # the dense inverse up to 12288 DOF, the two-grid above
        use_band = (self.operator_layout == "band"
                    or (self.operator_layout == "auto" and n >= 8192))
        precond = self.precond
        if precond == "auto":
            precond = "mg" if n > 12288 else "dense"
        if precond == "mg" and not self.geometry.can_coarsen:
            # the two-grid regenerates a coarser mesh; a .msh import cannot.
            # "auto" takes the dense preconditioner (any n, slower above
            # ~12k DOF); an explicit 'mg' is a user error
            if self.precond == "mg":
                raise ValueError(
                    "precond='mg' needs a coarsenable geometry (template or "
                    ".edp script); this mesh-imported geometry has none. "
                    "Use precond='dense'.")
            warnings.warn(
                f"n_free={n} would use the mg preconditioner, but this "
                "mesh-imported geometry cannot be coarsened; falling back "
                "to the dense complement preconditioner (slower above "
                "~12k DOF).", RuntimeWarning)
            precond = "dense"
        basis_f32 = bool(self.basis_f32)
        self._tier = ("band" if use_band else "flat", precond, basis_f32)
        if use_band:
            layout = build_band_layout(op.pattern.rows, op.pattern.cols, n)
            rows_h, cols_h = permute_pattern(layout, op.pattern.rows,
                                             op.pattern.cols)

            def pvec(v, axis=-1):
                return permute_vector(layout, v, axis=axis)
        else:
            layout = None
            rows_h, cols_h = op.pattern.rows, op.pattern.cols

            def pvec(v, axis=-1):
                return v

        self._band_layout = layout
        K_ref_eq = K_ref * ss
        M_eq = self.MInertia * ss

        flat_mg = precond == "mg" and layout is None
        if flat_mg:
            # ---- flat tier: the recursive Galerkin multilevel (JAX
            # problem.py:1244-1290, 1340-1358), its coarsest level inverted
            # on the device in f64 below
            mg_arrays, mg_static = build_multilevel_host(
                K_ref_eq, rows_h, cols_h, n, self._mg_chain(n),
                row_scale=scale_vec, invert_coarse=False)
            Kc_coo = mg_arrays.pop("Kc_coo")
        elif precond == "mg":
            # ---- band tier two-grid: one coarse level, aimed directly at
            # the dense-invertible size (n scales ~ factor^-2)
            factor = max(2.0, float(np.sqrt(n / (0.62 * self.mg_coarse_max))))
            c_mesh, c_free, c_constrained = self._coarse_level(factor)
            if c_free.size >= n or c_free.size < 60:
                raise ValueError(
                    "precond='mg' could not build a coarser mesh level for "
                    f"this geometry (n_free={n}).")
            P = build_prolongation(self.mesh, c_mesh, op.free_idx, c_free,
                                   op.constrained, c_constrained,
                                   three_field=not symmetric)
            P = P[layout.perm, :].tocsr()
            P = (sp.diags(1.0 / pvec(scale_vec)) @ P).tocsr()
            rl = build_rect_band(P, layout)
            Ksp = sp.csr_matrix((K_ref_eq, (rows_h, cols_h)), shape=(n, n))
            Ksp = 0.5 * (Ksp + Ksp.T)
            Pp = P[:, rl.perm_c]
            Kc = _pin_dead((Pp.T @ (Ksp @ Pp)).tocsc(), Pp)
            Kc = (0.5 * (Kc + Kc.T)).tocsc()
            dinv, lmax = _dinv_lmax(Ksp)
            self._mg_lmax = lmax
            self._mg_rl = rl
            self._mg_Kc = Kc

        def t64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        given = self._given_opdata is not None
        if given:
            opdata = self._given_opdata
        else:
            opdata = self._operator_data(ss, scale_vec, rows_h, cols_h, pvec)
            if layout is not None:
                opdata["band_lin"] = torch.as_tensor(
                    layout.lin, dtype=torch.int64, device=dev)
            if flat_mg:
                opdata["Kref64"] = t64(K_ref_eq)
            elif precond == "mg":
                # the coarse Galerkin operator is too ill-conditioned for
                # any f32 factorization: invert it with a host f64 splu
                t0 = time.perf_counter()
                Kc_inv = spla.splu(Kc).solve(np.eye(Kc.shape[0]))
                self._coarse_inv_s = time.perf_counter() - t0
                opdata |= {
                    "Kref64": t64(K_ref_eq),
                    "mg_band0": flat_to_band(
                        torch.as_tensor(K_ref_eq, dtype=F32, device=dev),
                        layout, opdata["band_lin"]),
                    "mg_dinv": torch.as_tensor(dinv, dtype=F32, device=dev),
                    "mg_Pt": rect_band_tensor(rl, dev),
                    "mg_slots": torch.as_tensor(rl.slots, dtype=torch.int64,
                                                device=dev),
                    "mg_Kcinv": torch.as_tensor(Kc_inv, dtype=F32,
                                                device=dev),
                }
            else:
                # the dense f64 inverse of the equilibrated reference
                # stiffness (ops/dense.py: why f64), built once on the
                # Problem's device
                t0 = time.perf_counter()
                opdata["invK64"] = inv_refined(
                    to_dense(t64(K_ref_eq), opdata["rows"], opdata["cols"],
                             n))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self._inv_build_s = time.perf_counter() - t0

        if flat_mg:
            # the hierarchy on the device with a K3 plan per level operator
            # and per P / P^T, and the coarsest inverse by the port's rule
            # for dense inverses: f64 (ops/dense.py), applied in f32
            Kc_inv = inv_refined(to_dense(
                t64(Kc_coo["data"]),
                torch.as_tensor(Kc_coo["rows"], dtype=torch.int64, device=dev),
                torch.as_tensor(Kc_coo["cols"], dtype=torch.int64, device=dev),
                int(Kc_coo["n"])))
            self._multilevel = multilevel_to_device(mg_arrays, mg_static, dev,
                                                    Kc_inv)
            self._mg_static = mg_static
        elif precond == "mg":
            # the f32 K_ref band of the preconditioner, packed once per
            # Problem into its nonzero tiles: every band_mv_f32 of every
            # sweep reads it
            t0 = time.perf_counter()
            pack = pack_band_tiles(opdata["mg_band0"], layout)
            if pack.vals.is_cuda:
                torch.cuda.synchronize(pack.vals.device)
            self._band_pack = pack
            self._pack_build_s = time.perf_counter() - t0

        # the CSR copy of the flat pattern, built once: K3 runs the flat
        # operator, the residual map and the panels' row sums on it
        csr = build_csr(opdata["rows"], opdata["cols"], n)

        if not given:
            # ---- band basis (theta-independent), after the preconditioner:
            # 'arpack' is the host shift-invert (one f64 splu), 'lobpcg' the
            # device LOBPCG with that preconditioner as T ~= K^-1
            basis = self.basis
            if basis == "lobpcg" and flat_mg:
                warnings.warn(
                    "basis='lobpcg' is not wired for the flat multilevel "
                    "preconditioner tier; falling back to the ARPACK host "
                    "basis.", RuntimeWarning)
                basis = "arpack"
            self._basis_resolved = basis
            om_max = 2.0 * np.pi * self.f_max
            t0 = time.perf_counter()
            if basis == "lobpcg":
                spec = ({"kind": "twogrid", "pack": self._band_pack,
                         "dinv": opdata["mg_dinv"], "Pt": opdata["mg_Pt"],
                         "Kc_inv": opdata["mg_Kcinv"],
                         "slots": opdata["mg_slots"], "lmax": lmax,
                         "layout": layout, "rl": rl, "refine": 8}
                        if precond == "mg" else
                        {"kind": "dense", "invK": opdata["invK64"],
                         "refine": 8})
                W64, lam = band_basis_lobpcg(
                    K_ref_eq, M_eq, rows_h, cols_h, n, om_max, precond=spec,
                    csr=csr, band_layout=layout,
                    band_lin=opdata.get("band_lin"))
                lam = lam.cpu().numpy()
            else:
                W64, lam = band_basis_host(K_ref_eq, M_eq, rows_h, cols_h, n,
                                           omega_max=om_max)
                W64 = t64(W64)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            # the basis's build seconds and its reference eigenvalues
            self._band_basis_s = time.perf_counter() - t0
            self._band_lam = lam
            opdata["W64"] = W64

        if flat_mg:
            Kref32 = opdata["Kref64"].to(F32)

        # the scalar-loss families have K_im = beta K_re exactly; per-modulus
        # loss factors carry K_im as a third operator
        ki_prop = bool(self.material.scalar_loss_factor)
        freq_chunk = self._auto_freq_chunk()

        def solve(K_re, K_im, B_re, B_im, omegas, od, adjoint,
                  diagnostics=False):
            band = (None if layout is None
                    else {"layout": layout, "lin": od["band_lin"]})
            if flat_mg:
                mg = {"multilevel": self._multilevel, "Kref32": Kref32}
            elif precond == "mg":
                mg = {"tg_pack": pack, "dinv": od["mg_dinv"],
                      "Pt": od["mg_Pt"], "Kc_inv": od["mg_Kcinv"],
                      "slots": od["mg_slots"], "lmax": lmax, "rl": rl,
                      "layout": layout}
            else:
                mg = None
            with torch.no_grad():
                return mixed_sweep(
                    K_re, K_im, od["MIn"], B_re, B_im, omegas,
                    od["rows"], od["cols"], n, od["W64"], band=band, mg=mg,
                    # the port's f64 inverse, or the JAX package's f32 one
                    # with its refinement operator (opdata_from_jax)
                    invK=od.get("invK64", od.get("invK32")),
                    K_ref32=od.get("Kref32"),
                    basis_f32=basis_f32, n_refine=self.n_refine,
                    refine_tol=self.refine_tol, freq_chunk=freq_chunk,
                    ki_proportional=ki_prop, k_cycle=self.k_cycle,
                    adjoint=adjoint, csr=csr, diagnostics=diagnostics)

        return self._make_core("mixed", csr, solve), opdata

    def _operator_data(self, ss: np.ndarray, scale_vec: np.ndarray,
                       rows_h: np.ndarray, cols_h: np.ndarray,
                       pvec: Callable = lambda v, axis=-1: v) -> dict:
        """The operator data every engine reads, f64 tensors on the
        Problem's device under the JAX opdata's keys: the pattern (rows,
        cols), the equilibrated flat mass ``MIn`` and inertia lift ``fIn``,
        and the path's stiffness stacks, lifts and readout rows (``Ks``,
        ``fKs``, ``c``, ``c0``, or ``ABD``, ``fABD``, ``ru``, ``rv``,
        ``rw``, ``r0``).  Flat data stays in the pattern's slot order; the
        vectors go through ``pvec`` (the band layout's RCM permutation)."""
        op = self.op
        dev = self.device

        def t64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        od = {
            "rows": torch.as_tensor(rows_h, dtype=torch.int64, device=dev),
            "cols": torch.as_tensor(cols_h, dtype=torch.int64, device=dev),
            "MIn": t64(self.MInertia * ss),
            "fIn": t64(pvec(self.fInertia * scale_vec)),
        }
        if self.is_symmetric_path:
            return od | {
                "Ks": t64(op.Ks * ss[None, :]),                # (6, nnz)
                "fKs": t64(pvec(op.fKs * scale_vec[None, :])),
                "c": t64(pvec(op.interpolation_vector * scale_vec)),
                "c0": t64(op.interpolation_value_from_bc),
            }
        acc = self.accelerometer
        eff = acc.effective_height * acc.height

        def row(name):
            R, r0 = op.readout[name]
            return np.asarray(R.mean(axis=0)), float(r0.mean())

        cu, ou = row("u")
        cv, ov = row("v")
        cw, ow = row("w")
        cwx, owx = row("wx")
        cwy, owy = row("wy")
        return od | {
            "ABD": t64(np.stack([
                op.mat_stack(["A" + s for s in MODULI_INDICES]),
                op.mat_stack(["B" + s for s in MODULI_INDICES]),
                op.mat_stack(["D" + s for s in MODULI_INDICES]),
            ]) * ss[None, None, :]),
            "fABD": t64(pvec(np.stack([
                op.lift_stack(["A" + s for s in MODULI_INDICES]),
                op.lift_stack(["B" + s for s in MODULI_INDICES]),
                op.lift_stack(["D" + s for s in MODULI_INDICES]),
            ]) * scale_vec[None, None, :])),
            "ru": t64(pvec((cu - eff * cwx) * scale_vec)),
            "rv": t64(pvec((cv - eff * cwy) * scale_vec)),
            "rw": t64(pvec(cw * scale_vec)),
            "r0": t64([ou - eff * owx, ov - eff * owy, ow]),
        }

    def _factor_core(self, engine: str, ss: np.ndarray,
                     scale_vec: np.ndarray, freq_dep: bool):
        """Core + opdata of the modal or direct engine (JAX
        ``_build_fr_core``): the shared operator data on the flat pattern in
        its own order, and the engine's solve.  The modal basis is built
        once per parameter set: a one-entry cache keyed on Re K's values,
        which the primal, adjoint and tangent solves of one derivative
        share."""
        from ..ops.csr_kernel import build_csr
        from ..ops.sweep import modal_basis, sweep_solve

        op = self.op
        n = op.n_free
        dev = self.device
        self._tier = None
        self._band_layout = None
        opdata = (self._given_opdata if self._given_opdata is not None
                  else self._operator_data(ss, scale_vec, op.pattern.rows,
                                           op.pattern.cols))
        csr = build_csr(opdata["rows"], opdata["cols"], n)
        ki_prop = bool(self.material.scalar_loss_factor)
        cache = {}
        self._modal_builds = 0

        def basis_of(K_re, od):
            key = K_re.detach()
            if "key" in cache and torch.equal(cache["key"], key):
                return cache["basis"]
            cache.clear()
            t0 = time.perf_counter()
            basis = modal_basis(key, od["MIn"], od["rows"], od["cols"], n,
                                self.n_modes, csr)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._basis_build_s = time.perf_counter() - t0
            self._modal_builds += 1
            cache.update(key=key.clone(), basis=basis)
            return basis

        def solve(K_re, K_im, B_re, B_im, omegas, od, adjoint):
            with torch.no_grad():
                basis = basis_of(K_re, od) if engine == "modal" else None
                return sweep_solve(
                    K_re, K_im, od["MIn"], B_re, B_im, omegas, od["rows"],
                    od["cols"], n, engine=engine, chunk=self.chunk,
                    adjoint=adjoint, csr=csr,
                    ki_proportional=ki_prop, basis=basis)

        return self._make_core(engine, csr, solve, freq_dep), opdata

    def _make_core(self, engine: str, csr, solve, freq_dep: bool = False):
        """The FRF core around an engine's ``solve(K_re, K_im, B_re, B_im,
        omegas, od, adjoint)``, with the hooks the implicit rules use: the
        coefficient chain, the right-hand side, the residual map through K3
        (``csr``, the pattern's CSR copy) and the readout are the same for
        every engine.  ``freq_dep``: the material transform depends on
        omega, so each lane has its own coefficients, (L, 3, 6) or (L, 6),
        and operator rows (L, nnz) (the direct engine only)."""
        from ..ops.mixed import mixed_apply
        from ..ops.sweep import lane_apply

        n = self.op.n_free
        h = self.geometry.height
        material = self.material
        symmetric = self.is_symmetric_path
        ki_prop = bool(material.scalar_loss_factor)

        if symmetric:
            def coefficients(params, od):
                """(Re, Im) of the K/lift combination: the 6 bending
                moduli against the (6, nnz) / (6, n) stacks."""
                Dre, Dim = material.d_split(params, h)
                return Dre, Dim, od["Ks"], od["fKs"], "k,kn->n"

            def lane_coefficients(params, omegas, od):
                """Per-lane (L, 6) moduli at each lane's omega, with the
                (6, nnz) / (6, n) stacks."""
                Dre, Dim = torch.func.vmap(
                    lambda om: material.d_split(params, h, om))(omegas)
                return Dre, Dim, od["Ks"], od["fKs"]
        else:
            def coefficients(params, od):
                (Are, Aim), (Bre, Bim), (Dre, Dim) = material.abd_split(
                    params, h)
                return (torch.stack([Are, Bre, Dre]),          # (3, 6)
                        torch.stack([Aim, Bim, Dim]), od["ABD"], od["fABD"],
                        "mk,mkn->n")

            def lane_coefficients(params, omegas, od):
                """Per-lane (L, 18) A/B/D moduli at each lane's omega, with
                the (18, nnz) / (18, n) stacks."""
                (Are, Aim), (Bre, Bim), (Dre, Dim) = torch.func.vmap(
                    lambda om: material.abd_split(params, h, om))(omegas)
                L = omegas.shape[0]
                return (torch.cat([Are, Bre, Dre], 1).reshape(L, 18),
                        torch.cat([Aim, Bim, Dim], 1).reshape(L, 18),
                        od["ABD"].reshape(18, -1), od["fABD"].reshape(18, -1))

        def stiffness(params, od, omegas=None):
            """(K_re, K_im) flat data at ``params``: (nnz,), or (L, nnz)
            at the lanes' ``omegas`` for a frequency-dependent material."""
            if freq_dep:
                Cre, Cim, stack, _ = lane_coefficients(params, omegas, od)
                return Cre @ stack, Cim @ stack
            Cre, Cim, stack, _, eq = coefficients(params, od)
            return torch.einsum(eq, Cre, stack), torch.einsum(eq, Cim, stack)

        def assemble(freqs, params, od):
            omegas = 2.0 * math.pi * freqs
            if freq_dep:
                Cre, Cim, stack, lifts = lane_coefficients(params, omegas, od)
                B_re = Cre @ lifts - (omegas ** 2)[:, None] * od["fIn"][None, :]
                return (Cre @ stack, Cim @ stack, B_re, Cim @ lifts, omegas)
            Cre, Cim, stack, lifts, eq = coefficients(params, od)
            K_re = torch.einsum(eq, Cre, stack)
            K_im = torch.einsum(eq, Cim, stack)
            bK_re = torch.einsum(eq, Cre, lifts)
            bK_im = torch.einsum(eq, Cim, lifts)
            B_re = bK_re[None, :] - (omegas ** 2)[:, None] * od["fIn"][None, :]
            B_im = bK_im[None, :].expand_as(B_re)
            return K_re, K_im, B_re, B_im, omegas

        def rhs(freqs, params, od):
            """b(theta) (B_re, B_im), each (F, n)."""
            if freq_dep:
                omegas = 2.0 * math.pi * freqs
                Cre, Cim, _, lifts = lane_coefficients(params, omegas, od)
                B_re = Cre @ lifts - (omegas ** 2)[:, None] * od["fIn"][None, :]
                return B_re, Cim @ lifts
            return assemble(freqs, params, od)[2:4]

        def sweep(freqs, params, od):
            """Primal sweep (U_re, U_im), each (F, n) f64, outside any
            autograd graph."""
            K_re, K_im, B_re, B_im, omegas = assemble(freqs, params, od)
            return solve(K_re, K_im, B_re, B_im, omegas, od, False)

        def sweep_rhs(freqs, params, od, B_re, B_im, adjoint=False):
            """A(theta) x = b (``adjoint``: conj(A) y = g, the transpose of
            the split-complex operator) for right-hand sides (L, n), lane i
            at frequency ``freqs[i]``: the tangent sweeps of the forward-
            mode derivatives run their p x F lanes through it as one
            batch."""
            omegas = 2.0 * math.pi * freqs
            K_re, K_im = stiffness(params, od, omegas)
            return solve(K_re, K_im, B_re, B_im, omegas, od, adjoint)

        def sweep_adj(freqs, params, od, G_re, G_im):
            """Adjoint sweep: conj(A) y = g per frequency, the transpose of
            the split-complex operator, for right-hand sides (F, n)."""
            return sweep_rhs(freqs, params, od, G_re, G_im, adjoint=True)

        def apply_op(freqs, params, od, U_re, U_im, adjoint=False):
            """A(theta) U (``adjoint``: conj(A(theta)) U) at fixed U, each
            (L, n) f64, differentiable in ``params`` (forward and reverse
            mode): K_im enters with the opposite sign."""
            omegas = 2.0 * math.pi * freqs
            if freq_dep:
                Cre, Cim, stack, _ = lane_coefficients(params, omegas, od)
                return lane_apply(Cre, Cim, stack, od["MIn"], omegas, U_re,
                                  U_im, csr, adjoint=adjoint)
            K_re, K_im = stiffness(params, od)
            return mixed_apply(K_re, -K_im if adjoint else K_im, od["MIn"],
                               omegas, U_re, U_im, od["rows"],
                               od["cols"], n, ki_proportional=ki_prop,
                               csr=csr)

        def apply_res(freqs, params, od, U_re, U_im):
            """The residual map A(theta) U - b(theta) at fixed U, each
            (F, n) f64, differentiable in ``params`` (forward and reverse
            mode)."""
            B_re, B_im = rhs(freqs, params, od)
            AU_re, AU_im = apply_op(freqs, params, od, U_re, U_im)
            return AU_re - B_re, AU_im - B_im

        if symmetric:
            def readout(U_re, U_im, od):
                """The complex amplitude c0 + U . c at the test point."""
                return torch.complex(od["c0"] + U_re @ od["c"],
                                     U_im @ od["c"])
        else:
            ts = self.accelerometer.transverse_sensitivity

            def readout(U_re, U_im, od):
                """The accelerometer magnitude from the disk-mean u, v, w
                rows."""
                def mag2(rvec, r0):
                    yr = U_re @ rvec + r0
                    yi = U_im @ rvec
                    return yr * yr + yi * yi

                u2 = mag2(od["ru"], od["r0"][0])
                v2 = mag2(od["rv"], od["r0"][1])
                w2 = mag2(od["rw"], od["r0"][2])
                return torch.sqrt(ts * ts * (u2 + v2) + w2)

        def core(freqs, params, od):
            """FRF (F,) at ``freqs`` (F,) for ``params``, both f64 tensors
            on the operator data's device: the real accelerometer magnitude
            (3-field path) or the complex test-point amplitude (symmetric
            path).  Differentiable in ``params``: the backward of the sweep
            is one adjoint sweep."""
            U_re, U_im = _ImplicitSweep.apply(params, freqs, od, core)
            return readout(U_re, U_im, od)

        if engine == "mixed":
            def core_diag(freqs, params, od):
                """(FRF, rn, rn_fin, rn0, tol): the primal sweep with its
                convergence signal (``mixed_sweep(diagnostics=True)``),
                outside any autograd graph."""
                K_re, K_im, B_re, B_im, omegas = assemble(freqs, params, od)
                U_re, U_im, *info = solve(K_re, K_im, B_re, B_im, omegas, od,
                                          False, diagnostics=True)
                return (readout(U_re, U_im, od), *info)

            core.diag = core_diag
        # the pieces the adjoint Gauss-Newton Jacobian, the gradient and the
        # forward-mode derivatives need; ``engine`` answers the public
        # adjoint predicate (_has_adjoint_hooks)
        core.engine = engine
        core.sweep_u = sweep
        core.sweep_adj = sweep_adj
        core.sweep_rhs = sweep_rhs
        core.apply_res = apply_res
        core.apply_op = apply_op
        core.readout_ui = readout
        return core

    def _reference_stiffness_flat(self) -> np.ndarray:
        """Flat (signed) Re K(theta_ref) data: equilibration scale source and
        the reference operator of the band basis and the preconditioner."""
        op = self.op
        if getattr(self, "parameters", None) is None:
            if self.is_symmetric_path:
                return op.Ks.sum(axis=0)
            return sum(v for k, v in op.mats.items() if k[0] in "ABD")
        theta = np.asarray(self.parameters, np.float64)
        h = self.geometry.height
        if self.is_symmetric_path:
            D = self.material.reference_d(theta, h)
            return np.einsum("k,kn->n", D, op.Ks)
        Av, Bv, Dv = self.material.reference_coeffs(theta, h)
        out = np.zeros(op.pattern.nnz)
        for i, s in enumerate(MODULI_INDICES):
            out += (Av[i] * op.mats["A" + s] + Bv[i] * op.mats["B" + s]
                    + Dv[i] * op.mats["D" + s])
        return out

    def _auto_freq_chunk(self, lanes: int = 1) -> int | None:
        """Frequencies per batch (None = one batch for small patterns).
        ``lanes`` counts the solves a frequency brings.  A sweep (1 lane)
        takes the JAX package's chunk (JAX ``Problem._auto_freq_chunk``),
        bounding its live f64 FGMRES state to ~2 GB.  The forward-mode
        r + J (1 + p lanes: the primal and one tangent per parameter) runs
        its sweeps in those chunks, so its own chunk bounds only the state
        it holds across them, ``_FWD_HELD_VECS`` f64 n-vectors a lane, to
        ``_fwd_budget``: the largest multiple of the sweep's chunk that
        fits, one at least."""
        if self.freq_chunk is not None:
            return self.freq_chunk
        if self.op.pattern.nnz <= 300_000:
            return None
        per_lane = (4.0 * self.n_refine + 6.0) * self.n_free * 8.0
        sweep = int(np.clip(
            2 ** np.floor(np.log2(max(2.0e9 / per_lane, 8.0))), 8, 64))
        if lanes == 1:
            return sweep
        held = _FWD_HELD_VECS * self.n_free * 8.0 * lanes * sweep
        return sweep * max(1, int(_fwd_budget(self.device) // held))

    def getFRFunction(self) -> Callable:
        """(freqs, params) -> FRF on the Problem's device: the f64
        accelerometer magnitude (3-field path) or the complex128 test-point
        amplitude (symmetric path).  The callable exposes ``.core`` and
        ``.opdata``."""
        memo = getattr(self, "_fr_fn_memo", None)
        if memo is not None:
            return memo
        core, opdata = self.getFRCore()
        dev = self.device

        def fn(freqs, params):
            freqs = torch.as_tensor(np.asarray(freqs, np.float64), device=dev)
            params = torch.as_tensor(np.asarray(params, np.float64),
                                     device=dev)
            return core(freqs, params, opdata)

        fn.core = core
        fn.opdata = opdata
        self._fr_fn_memo = fn
        return fn

    def _check_band(self, freqs) -> None:
        """Warn when the sweep leaves the mixed engine's preconditioned band."""
        if self.getFRCore()[0].engine != "mixed":
            return
        fmax = float(np.max(np.asarray(freqs)))
        if fmax > self.f_max * 1.0001:
            warnings.warn(
                f"Sweep reaches {fmax:.1f} Hz but the mixed engine's band "
                f"basis was built for f_max={self.f_max:.1f} Hz; accuracy "
                "and refinement convergence degrade above the band. "
                "Recreate the Problem with f_max >= the sweep maximum.",
                RuntimeWarning)

    def solveForward(self, freqs: np.ndarray, params: np.ndarray = None,
                     polish_peaks=False) -> torch.Tensor:
        """Forward FRF for a set of frequencies [Hz] (reference
        Problem.py:611-639), a tensor on the device: real magnitude on the
        3-field path, complex amplitude on the symmetric path.

        ``polish_peaks``: True polishes the global |FRF| peak, an int k the
        k largest local maxima, a sequence explicit indices: each gets one
        host-exact residual correction fed back through the engine
        (``diagnostics.oracle.polish_peaks``; the modal and direct engines
        take the host splu value there); the other points are returned as
        the sweep gave them.
        """
        if params is None:
            params = self.parameters
        self._check_band(freqs)
        fr = self.getFRFunction()(freqs, params)
        if polish_peaks is False or polish_peaks is None:
            return fr
        from ..diagnostics.oracle import polish_peaks as _polish

        peaks = 1 if polish_peaks is True else polish_peaks
        fr_pol, _ = _polish(self, freqs, fr=fr, params=_numpy(params),
                            peaks=peaks)
        return torch.as_tensor(fr_pol, device=fr.device)

    def diagnoseSweep(self, freqs, params: np.ndarray = None) -> dict:
        """Per-frequency convergence signal of the mixed engine's sweep
        (JAX ``Problem.diagnoseSweep``): the identical solve, with its
        convergence bookkeeping returned.  A dict of numpy arrays over the
        sweep:

        * ``fr`` — the FRF values (as :meth:`solveForward` gives them);
        * ``residual_norm`` — the TRUE f64 residual norm the Krylov loop
          exited with (what its stopping test compared);
        * ``final_residual_norm`` — the true residual of the returned
          iterate after the final band corrections, which trade residual
          norm in benign directions for resonance-amplified solution error
          (report it, do not gate on it);
        * ``initial_residual_norm`` — the residual norm of the band-
          resolvent start;
        * ``target`` — the amplification-aware norm target of the solve;
        * ``converged`` — the solve reached its target or reduced the
          residual of its start by 9 orders of magnitude.

        The modal and direct engines are factorisations, whose accuracy is
        not iteration-bounded: on them it raises ``ValueError``.
        """
        engine = self.getFRCore()[0].engine
        if engine != "mixed":
            raise ValueError(
                "diagnoseSweep applies to the iterative mixed engine; the "
                f"resolved engine here is {engine!r} "
                "(modal/direct solves are direct factorizations — their "
                "accuracy is not iteration-bounded).")
        if params is None:
            params = self.parameters
        self._check_band(freqs)
        core, od = self.getFRCore()
        dev = self.device
        out = core.diag(torch.as_tensor(np.asarray(freqs, np.float64),
                                        device=dev),
                        _as_tensor(params, dev), od)
        y, rn, rn_fin, rn0, tol = (_numpy(v) for v in out)
        return {
            "fr": y,
            "residual_norm": rn,
            "final_residual_norm": rn_fin,
            "initial_residual_norm": rn0,
            "target": tol,
            "converged": (rn <= tol * (1.0 + 1e-12)) | (rn <= 1e-9 * rn0),
        }

    def mode_field(self, freq: float, params: np.ndarray = None
                   ) -> np.ndarray:
        """Vertex deflection magnitudes |w| (mesh.num_nodes,) at one
        frequency [Hz]: one host complex128 ``splu`` solve of the
        Dirichlet-reduced operator (as ``oracle.py`` assembles it), mapped
        by ``vertex_w``.  ``getModePicture`` renders these values; this
        helper imports no matplotlib."""
        import scipy.sparse.linalg as spla

        from ..oracle import _operator

        theta = np.asarray(self.parameters if params is None else params,
                           np.float64)
        K, M, bK = _operator(self, theta)
        om2 = (2.0 * np.pi * float(freq)) ** 2
        u = spla.splu((K - om2 * M).tocsc()).solve(bK - om2 * self.fInertia)
        return self.vertex_w(u)

    def vertex_w(self, u: np.ndarray) -> np.ndarray:
        """Vertex |w| (mesh.num_nodes,) of a solution ``u`` (n_free,) on
        the free DOFs in the Problem's DOF order, the constrained DOFs at
        their boundary values.  The Morley vertex DOFs are the P1 nodal
        values; on the 3-field path the w block starts at 2 x num_nodes."""
        op = self.op
        complete = np.array(op.boundary_value, np.float64)
        complete[~op.constrained] = np.abs(u)
        V = self.mesh.num_nodes
        w_off = 0 if self.is_symmetric_path else 2 * V
        return complete[w_off: w_off + V]

    def getModePicture(self, freq: float, use_freefem: bool = False,
                       params: np.ndarray = None, ax=None):
        """Deflection-magnitude contour at one frequency (reference
        Problem.py:521-608, JAX ``Problem.getModePicture``): the vertex |w|
        of ``mode_field`` drawn on the mesh with matplotlib (imported here,
        and only here).  ``use_freefem`` selects the reference's FreeFEM
        window; there is no FreeFEM process, so it warns and draws the same
        field with matplotlib.  Returns the vertex values."""
        if use_freefem:
            warnings.warn(
                "use_freefem=True: no FreeFEM process in this framework; "
                "rendering the same P1 deflection field with matplotlib "
                "instead", stacklevel=2)
        vertex_vals = self.mode_field(freq, params)

        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        tri = self.mesh.to_matplotlib_tri()
        cf = ax.tricontourf(tri, vertex_vals, 2000, cmap="coolwarm",
                            norm="symlog", antialiased=False)
        ax.set_aspect("equal")
        plt.colorbar(cf, ax=ax, orientation="horizontal", location="bottom",
                     pad=0.05)
        self.mesh.plot(ax=ax, alpha=0.4)
        ax.axis("off")
        return vertex_vals

    def getSolutionMatrices(self, D, beta):
        """Flat (K_real, K_imag, MInertia) data of the symmetric path for
        the bending moduli ``D`` (6,) and loss factor ``beta``, f64 tensors
        on the Problem's device (Problem.py:923-930 analog)."""
        if not self.is_symmetric_path:
            raise NotImplementedError(
                "Solution matrices for the 3-field path.")
        dev = self.device
        D = torch.as_tensor(np.asarray(D, np.float64), device=dev)
        Ks = torch.as_tensor(self.op.Ks, device=dev)
        K_real = torch.einsum("k,kn->n", D, Ks)
        K_imag = torch.einsum("k,kn->n", beta * D, Ks)
        return K_real, K_imag, torch.as_tensor(self.MInertia, device=dev)

    # ------------------------------------------------------------------

    def getLossFunction(self, frequencies, reference_fr, func_type: str,
                        scaling_params=None) -> LossFunction:
        """Loss factory; types MSE / RMSE / MSE_AFC / MSE_LOG_AFC
        (reference Problem.py:933-980).  Returns a :class:`LossFunction`:
        ``f(params) -> scalar`` with ``.grad`` and ``.value_and_grad``."""
        assert np.shape(frequencies)[0] == np.shape(reference_fr)[0]
        self._check_band(frequencies)
        core, opdata = self.getFRCore()
        return LossFunction(core, opdata, frequencies, reference_fr,
                            func_type, scaling_params)

    def getResidualFunction(self, frequencies, reference_fr,
                            kind: str = "log_afc", scaling_params=None,
                            freq_chunk: int | None = None,
                            jac_mode: str = "auto") -> ResidualFunction:
        """Vector-residual factory for Gauss-Newton
        (``optimize.optimize_gauss_newton``), see :class:`ResidualFunction`.
        ``freq_chunk`` bounds the forward-mode Jacobian's memory for large
        sweeps x many parameters; left None, the forward mode of a scalar
        kind takes ``_auto_freq_chunk(lanes=1 + p)`` (None below 300k
        pattern entries, as in the JAX package).  ``jac_mode``: 'adjoint' |
        'fwd' | 'auto'."""
        assert np.shape(frequencies)[0] == np.shape(reference_fr)[0]
        self._check_band(frequencies)
        core, opdata = self.getFRCore()
        adjoint_selected = (jac_mode in ("auto", "adjoint")
                            and kind in ("log_afc", "afc")
                            and _has_adjoint_hooks(core))
        if freq_chunk is None and kind != "complex" and not adjoint_selected:
            freq_chunk = self._auto_freq_chunk(
                lanes=1 + len(np.asarray(self.parameters)))
        return ResidualFunction(core, opdata, frequencies, reference_fr,
                                kind, scaling_params, freq_chunk=freq_chunk,
                                jac_mode=jac_mode)

    def solveInverse(self, arg0, loss_type: str, optimizer: str,
                     compression: tuple = (False, 0), comp_alg: int = 1,
                     ref_fr: tuple = None, use_rel: bool = False,
                     use_scaling: bool = False,
                     use_constraints: bool = False, report: bool = True,
                     log: bool = True, case_name: str = "", uid: str = None,
                     extra_info: str = "", **opt_kwargs) -> optResult:
        """Inverse solve from an initial guess or bounds (reference
        Problem.py:641-914, JAX ``Problem.solveInverse``).

        Optimizers: Gauss-Newton ('gn' / 'gauss_newton') on the residual's
        Jacobian (MSE / RMSE run the 'complex' residual, its forward-mode
        Jacobian), trust region ('trust_region' / 'tr') and damped Newton
        ('newton') on the loss Hessian, 'lbfgs', gradient descent ('gd' /
        'grad_descent'), coordinate descent ('cd' / 'coord_descent') and
        its adaptive-step variant ('cd_mem' / 'coord_descent_mem',
        ``optimize_cd_mem2`` as in the JAX package), and scipy's global
        optimizers 'de' (differential evolution) and 'shgo' (whose local
        minimizer gets the loss gradient and Hessian; ``use_constraints``
        passes the material's constraints).  ``compression=(True, k)``
        first reduces the reference FRF to k points
        (``io.compress.Compressor``, algorithm ``comp_alg``).

        ``arg0`` is a 1-D start point — absolute, or with ``use_rel``
        relative corrections on the Problem's own parameters, theta_0 =
        (1 + arg0) * parameters — or, for 'de' and 'shgo', a 2-D (p, 2)
        bounds box.  ``use_scaling`` iterates on O(1) variables: theta /
        theta_0, or each box row over its largest magnitude.  ``report``
        prints and writes the text report, ``log`` the ``.npz`` history,
        both under ``utils.paths.get_output_dir()``.  Returns an
        :class:`optResult` with host numpy iterates in physical units, or
        scipy's ``OptimizeResult`` with the same fields added.
        """
        if ref_fr is None:
            ref_fr = getattr(self, "reference_fr", None)
            if ref_fr is None:
                raise ValueError(
                    "Cannot solve inverse problem as `ref_fr` argument was "
                    "not provided and the Problem object doesn't have a "
                    "reference_fr attribute.")
        ref_fr = [_numpy(ref_fr[0]), _numpy(ref_fr[1])]
        if not isinstance(compression, tuple):
            raise TypeError(
                "`compression` argument should have a type `tuple`, not "
                f"{type(compression)}.")
        if len(compression) != 2:
            raise ValueError("`compression` tuple should have 2 elements, "
                             f"not {len(compression)}.")
        from scipy.optimize import OptimizeResult, differential_evolution, shgo

        from ..optimize import (
            optimize_cd, optimize_cd_mem2, optimize_gauss_newton, optimize_gd,
            optimize_lbfgs, optimize_newton, optimize_trust_region)

        local = {"trust_region": optimize_trust_region,
                 "tr": optimize_trust_region,
                 "gauss_newton": "GN", "gn": "GN",
                 "coord_descent": optimize_cd, "cd": optimize_cd,
                 "coord_descent_mem": optimize_cd_mem2,
                 "cd_mem": optimize_cd_mem2,
                 "grad_descent": optimize_gd, "gd": optimize_gd,
                 "newton": optimize_newton, "lbfgs": optimize_lbfgs}
        if optimizer not in local and optimizer not in ("de", "shgo"):
            raise ValueError(f"Optimizer type `{optimizer}` is not supported!")
        if compression[0]:
            from ..io.compress import Compressor

            comp = Compressor(ref_fr[0], ref_fr[1], compression[1], comp_alg)
            ref_fr[0], ref_fr[1] = comp(compression[1])

        # a 1-D arg0 is a start point — absolute, or with use_rel relative
        # corrections on the Problem's own parameters; a 2-D arg0 is a
        # per-parameter bounds box for the global optimizers.  use_scaling
        # iterates on O(1) variables while the loss multiplies the scale
        # back in (JAX Problem.solveInverse)
        guess = np.asarray(arg0, dtype=np.float64)
        scaling_params = None
        if guess.ndim == 2:
            x0_bds = guess
            if use_scaling:
                # each bounds row maps to O(1) by its largest magnitude
                scaling_params = np.max(np.abs(guess), axis=1)
                x0_bds = guess / scaling_params[:, None]
        elif guess.ndim == 1:
            if use_rel:
                base = getattr(self, "parameters", None)
                if base is None:
                    raise ValueError(
                        "use_rel=True reads arg0 as relative corrections on "
                        "the Problem's own parameter vector, but this "
                        "Problem carries none (material built without "
                        "parameters).")
                factors = guess + 1.0
                start = np.asarray(base, np.float64) * factors
            else:
                factors = None
                start = guess
            if use_scaling:
                scaling_params = start
                x0_bds = factors if use_rel else np.ones_like(start)
            else:
                x0_bds = start
        else:
            raise ValueError("arg0 must be a 1-D start point or a 2-D bounds "
                             f"box; got ndim={guess.ndim}.")

        loss = self.getLossFunction(ref_fr[0], ref_fr[1], loss_type,
                                    scaling_params)
        # the report and the constraints want a filled scaling array; a
        # bounds box carries it once per bound column
        if scaling_params is None:
            scaling_params = np.ones_like(x0_bds)
        elif x0_bds.ndim == 2:
            scaling_params = np.repeat(scaling_params[:, None], 2, axis=1)
        scale_1d = (scaling_params if scaling_params.ndim == 1
                    else scaling_params[:, 0])

        if optimizer in local:
            optimizer_func = local[optimizer]
            if optimizer_func == "GN":
                kind = {"MSE": "complex", "RMSE": "complex",
                        "MSE_AFC": "afc", "MSE_LOG_AFC": "log_afc"}.get(
                            loss_type)
                if kind is None:
                    raise ValueError(
                        f'Function type "{loss_type}" is not supported!')
                resfn = self.getResidualFunction(
                    ref_fr[0], ref_fr[1], kind=kind,
                    scaling_params=None if np.all(scale_1d == 1.0)
                    else scale_1d)

                def optimizer_func(_loss, x0, **kw):
                    return optimize_gauss_newton(resfn, x0, **kw)
        else:
            # scipy calls the objective and its derivatives with numpy
            # points and wants host numbers back
            def objective(x):
                return float(loss(x))

            run = differential_evolution if optimizer == "de" else shgo
            if optimizer == "shgo":
                if use_constraints:
                    opt_kwargs["constraints"] = self.material.get_constraints(
                        scale_1d)
                options = opt_kwargs.get("options", {})
                options["jac"] = lambda x: _numpy(loss.grad(x))
                options["hess"] = lambda x: _numpy(loss.hessian(x))
                opt_kwargs["options"] = options

            def optimizer_func(_loss, bounds, **kw):
                return run(objective, bounds, **kw)

        t_start = time.perf_counter()
        result = optimizer_func(loss, x0_bds, **opt_kwargs)
        elapsed = (time.perf_counter() - t_start) / 60
        x_scale = (scaling_params if scaling_params.ndim == 1
                   else scaling_params[:, 1])
        if optimizer in ("de", "shgo"):
            if use_scaling:
                result = OptimizeResult(dict(result) | {
                    "x": result["x"] * x_scale})
            # scipy results in optResult's fields (reference
            # Problem.py:855-863)
            result.f = result.fun
            result.x_history = list(result.population if optimizer == "de"
                                    else result.xl)
            result.f_history = [-1.0]
            result.status = result.message
            result.niter = result.nit
        elif use_scaling:
            result = result._replace(x=result.x * x_scale)

        full_str = case_name + (default_uid() if uid is None else uid)
        if report:
            rel_err1 = rel_err2 = "Unknown"
            if getattr(self, "parameters", None) is not None:
                params0 = np.array(self.parameters)
                if guess.ndim != 2:
                    rel_err1 = (x0_bds * scaling_params - params0) / params0
                rel_err2 = (np.array(result.x) - params0) / params0

            def a2s(s):
                if isinstance(s, str):
                    return s
                return np.array2string(np.array(s), separator=", ",
                                       precision=5)

            comp_str = ""
            if compression[0]:
                comp_str = (f"Using compression algorithm {comp_alg} with "
                            f"{compression[1]} points.\n")
            f0 = result.f_history[0] if len(result.f_history) else float("nan")
            s_pa_bd = "parameters" if guess.ndim == 1 else "bounds"
            rep_str = (
                f"{self.accelerometer}\n{self.material}\n{self.geometry}\n"
                + extra_info
                + comp_str
                + f"Starting {s_pa_bd}: {a2s(x0_bds * scaling_params)}.\n"
                f"With relative error: {a2s(rel_err1)}.\n"
                f"Initial loss: {f0}.\n"
                f"Elapsed time: {elapsed} min.\n"
                f"After optimization: {a2s(result.x)}.\n"
                f"With relative error: {a2s(rel_err2)}.\n"
                f"Resulting loss: {result.f}.\n"
                f"Optimization status: {result.status}.\n"
                f"Optimizer parameters: {opt_kwargs}.\n"
                f"Optimizer type: {optimizer}.\n"
                f"Scaling parameters used: {scaling_params}.\n"
            )
            print(rep_str, end="")
            write_report(full_str, rep_str)
        if log:
            write_log(full_str, result)
        return result

    def solveInverseLocal(self, *args, **kwargs):
        """Alias for ``solveInverse`` (reference Problem.py:916-921)."""
        return self.solveInverse(*args, **kwargs)
