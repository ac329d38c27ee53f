"""Problem: geometry + material + accelerometer -> FRF sweep on a device.

Port of the JAX package's ``models/problem.py`` for the mixed engine's
3-field (laminate) path on its three tiers: the flat f64 operator with the
dense preconditioner (n < 8192), the RCM block-tridiagonal f64 operator
with the dense preconditioner (8192 <= n <= 12288) or with the two-grid f32
preconditioner (n > 12288).  Operator data is a plain dict of tensors under
the JAX opdata's key names; ``getFRCore`` returns a plain function of
(freqs, params, opdata).

Options that resolve to what this port does not have yet raise
``NotImplementedError`` naming the ROADMAP item; nothing falls back.  The
port's materials carry no frequency dependence (``Material.real_coeffs``
takes no omega), so the JAX side's frequency-dependent fallback to the
direct engine has no counterpart.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Callable

import numpy as np
import torch

from ..config import F32
from ..fem.assembly import (
    MODULI_INDICES,
    _uvw_constraints,
    accel_indicator,
    assemble_unsymm,
)
from ..io.report import default_uid, write_log, write_report
from ..optimize import optResult
from .accelerometer import Accelerometer
from .geometry import Geometry
from .materials import Material


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
    return all(hasattr(core, a) for a in _ADJOINT_HOOKS)


class _ImplicitSweep(torch.autograd.Function):
    """U(theta) = A(theta)^-1 b(theta) with the adjoint backward — the role
    ``lax.custom_linear_solve`` and its ``transpose_solve`` play in the JAX
    package.

    Forward: the primal sweep, outside the graph.  Backward, for the
    cotangent G = dL/dU: one adjoint sweep conj(A) Y = G, then
    dL/dtheta = -d/dtheta [sum Y . (A(theta) U - b(theta))] at fixed U and
    Y, by autograd through the solve-free residual map."""

    @staticmethod
    def forward(ctx, params, freqs, od, core):
        U_re, U_im = core.sweep_u(freqs, params, od)
        ctx.core, ctx.freqs, ctx.od = core, freqs, od
        ctx.save_for_backward(params, U_re, U_im)
        return U_re, U_im

    @staticmethod
    def backward(ctx, g_re, g_im):
        params, U_re, U_im = ctx.saved_tensors
        core, freqs, od = ctx.core, ctx.freqs, ctx.od
        th = params.detach()
        Y_re, Y_im = core.sweep_adj(freqs, th, od, g_re, g_im)
        with torch.enable_grad():
            th = th.requires_grad_(True)
            R_re, R_im = core.apply_res(freqs, th, od, U_re, U_im)
            psi = (Y_re * R_re).sum() + (Y_im * R_im).sum()
            (g,) = torch.autograd.grad(psi, th)
        return -g, None, None, None


class LossFunction:
    """Scalar loss of the FRF against a reference: ``f(params) -> scalar``
    with ``value_and_grad`` and ``grad`` (JAX ``LossFunction``).

    Types MSE / RMSE / MSE_AFC / MSE_LOG_AFC, each the mean of a
    per-frequency term.  The gradient costs one primal and one adjoint
    sweep (``_ImplicitSweep``).  Values and gradients are f64 tensors on
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

        # the 3-field path's FRF is a real magnitude: Im fr = 0
        if func_type == "MSE":
            def term(fr, ref):
                return (fr - ref[..., 0]) ** 2 + ref[..., 1] ** 2
        elif func_type == "RMSE":
            def term(fr, ref):
                return (((fr - ref[..., 0]) ** 2 + ref[..., 1] ** 2)
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
        raise NotImplementedError(
            "The loss Hessian (and the trust-region and Newton optimizers "
            "that use it) is not ported yet (ROADMAP Queue 1, item D).")

    def value_grad_hessian(self, params):
        raise NotImplementedError(
            "The loss Hessian (and the trust-region and Newton optimizers "
            "that use it) is not ported yet (ROADMAP Queue 1, item D).")


class ResidualFunction:
    """Vector residual r(theta) with the adjoint Gauss-Newton Jacobian
    (JAX ``ResidualFunction``, ``jac_mode='adjoint'``).

    kinds: 'log_afc' (r_i = log|fr_i| - log|ref_i|, the Gauss-Newton
    counterpart of MSE_LOG_AFC) and 'afc' (|fr| - |ref|).  Each row is a
    per-frequency scalar, so J costs two batched sweeps — the primal and
    one adjoint sweep conj(A_i) y_i = dr_i/dU_i — plus p forward tangents of
    the solve-free residual map psi_i(theta) = y_i . (A_i(theta) U_i -
    b_i(theta)), J = -dpsi/dtheta, whatever the parameter count p.
    ``jac_mode='auto'`` resolves to 'adjoint'.  r and J are f64 tensors on
    the operator data's device.
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
            raise NotImplementedError(
                "The 'complex' residual kind needs the forward-mode "
                "Jacobian, which is not ported yet (ROADMAP Queue 1, item "
                "C: jac_mode='fwd').")
        else:
            raise ValueError(f"Unknown residual kind {kind!r}.")
        if jac_mode not in ("auto", "adjoint", "fwd"):
            raise ValueError(f"Unknown jac_mode {jac_mode!r}.")
        if jac_mode == "fwd" or not _has_adjoint_hooks(core):
            raise NotImplementedError(
                "The forward-mode Jacobian (jac_mode='fwd', and any core "
                "without the adjoint hooks) is not ported yet (ROADMAP "
                "Queue 1, item C).")
        if freq_chunk is not None:
            raise NotImplementedError(
                "freq_chunk chunks the forward-mode Jacobian, which is not "
                "ported yet (ROADMAP Queue 1, item C: jac_mode='fwd'); the "
                "adjoint Jacobian's memory is bounded by the sweep's and "
                "the residual map's own chunking.")
        dev = opdata["rows"].device
        self._core = core
        self._opdata = opdata
        self._device = dev
        self._freqs = _as_tensor(frequencies, dev)
        self._ref = _split_ref(reference_fr, dev)
        self._scaling = (1.0 if scaling_params is None
                         else _as_tensor(scaling_params, dev))
        self._resid = resid
        self.kind = kind
        self.jac_mode = "adjoint"

    def __call__(self, params):
        th = _as_tensor(params, self._device)
        with torch.no_grad():
            fr = self._core(self._freqs, th * self._scaling, self._opdata)
            return self._resid(fr, self._ref)

    def value_and_jac(self, params):
        core, od, freqs, ref = self._core, self._opdata, self._freqs, \
            self._ref
        params = _as_tensor(params, self._device)
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
    caller asks for ``"cpu"``)."""

    def __init__(
        self,
        geometry: Geometry,
        material: Material,
        accel: Accelerometer,
        *,
        device: torch.device | str = "cuda",   # "cpu" on request
        engine: str | None = "mixed",   # the mixed engine only
        f_max: float = 600.0,           # band edge of the basis [Hz]
        n_refine: int = 16,             # TOTAL Krylov budget
        k_cycle: int | None = None,     # FGMRES cycle length (None = 8)
        refine_tol: float = 3e-7,       # residual target (tracks the
                                        # delivered FRF accuracy ~1:1)
        precond: str = "auto",          # 'dense' / 'mg' (two-grid, band
                                        # layout only); auto: dense up to
                                        # 12288 DOF
        mg_coarse_max: int = 11500,     # sets the coarsening factor
        freq_chunk: int | None = None,  # lanes per batch (None = auto)
        operator_layout: str = "auto",  # 'flat' / 'band'; auto: band from
                                        # 8192 DOF
        basis: str = "arpack",          # how the band basis is computed
        basis_f32: bool | None = None,  # f32 Krylov basis storage (None:
                                        # on the dense tier)
        opdata: dict | None = None,     # operator data to use instead of
                                        # building it (convert.py)
    ):
        if engine not in (None, "mixed"):
            raise NotImplementedError(
                f"engine={engine!r} is not ported yet (ROADMAP Queue 1, item "
                "13: other engines); the port runs the mixed engine.")
        if precond not in ("auto", "dense", "mg"):
            raise ValueError(f"Unknown precond {precond!r}; valid options: "
                             "'auto', 'dense', 'mg'.")
        if operator_layout not in ("auto", "flat", "band"):
            raise ValueError(f"Unknown operator_layout {operator_layout!r}; "
                             "valid options: 'auto', 'flat', 'band'.")
        if basis not in ("arpack", "lobpcg"):
            raise ValueError(f"Unknown basis {basis!r}; valid options: "
                             "'arpack', 'lobpcg'.")
        if basis == "lobpcg":
            raise NotImplementedError(
                "basis='lobpcg' is not ported yet (ROADMAP Queue 1, item 12).")
        if None in (geometry, material):
            raise ValueError("A Problem needs a geometry and a material.")
        self.device = torch.device(device)
        self.f_max = f_max
        self.n_refine = n_refine
        self.k_cycle = k_cycle
        self.refine_tol = float(refine_tol)
        self.precond = precond
        self.mg_coarse_max = int(mg_coarse_max)
        self.freq_chunk = freq_chunk
        self.operator_layout = operator_layout
        self.basis_f32 = basis_f32
        self._given_opdata = opdata

        self.accelerometer = accel
        self.material = material
        self.geometry = geometry
        if self.material.has_params:
            self.parameters = self.material.get_parameters()
        else:
            warnings.warn(
                "Some elastic moduli of a material were not provided, solving "
                "forward problem as standalone will not be possible.",
                RuntimeWarning)
        rho = self.material.density
        h = self.geometry.height
        mesh = self.geometry.get_mesh()
        self.mesh = mesh

        self.is_symmetric_path = (self.material.is_mps
                                  and self.accelerometer is None)
        if self.is_symmetric_path:
            raise NotImplementedError(
                "The symmetric (pure-bending, no accelerometer) path is not "
                "ported yet (ROADMAP Queue 1, items 3 and 6).")
        if (self.geometry.accel_x is None or self.geometry.accel_y is None
                or self.geometry.accel_r is None):
            raise ValueError("The 3-field (unsymmetric) path needs an "
                             "accelerometer disk position on the geometry.")
        indicator = accel_indicator(self.geometry.accel_x,
                                    self.geometry.accel_y,
                                    self.geometry.accel_r)

        # inertia constants (physical form, reference Problem.py:361-374)
        self.I0 = h * rho
        self.I2 = rho * h**3 / 12.0
        rho_corr = (self.accelerometer.mass
                    / (np.pi * self.accelerometer.radius**2)
                    / self.accelerometer.height)
        self.I0Corr = self.accelerometer.height * rho_corr
        self.I2Corr = rho_corr / 3.0 * (
            (h / 2.0 + self.accelerometer.height) ** 3 - h**3 / 8.0)

        op = assemble_unsymm(
            mesh, (self.geometry.accel_x, self.geometry.accel_y),
            self.geometry.accel_r, indicator=indicator,
            clamped_labels=getattr(self.geometry, "clamped_labels", (1,)))
        self.op = op
        self.MInertia = (
            self.I0 * (op.mats["M11"] + op.mats["M22"] + op.mats["M33"])
            + self.I0Corr * (op.mats["M11C"] + op.mats["M22C"] + op.mats["M33C"])
            + self.I2 * op.mats["M33I2"]
            + self.I2Corr * op.mats["M33I2C"]
        )
        self.fInertia = (
            self.I0 * (op.lifts["M11"] + op.lifts["M22"] + op.lifts["M33"])
            + self.I0Corr * (op.lifts["M11C"] + op.lifts["M22C"] + op.lifts["M33C"])
            + self.I2 * op.lifts["M33I2"]
            + self.I2Corr * op.lifts["M33I2C"]
        )
        self.n_free = op.n_free

    # ------------------------------------------------------------------

    def getFRCore(self):
        """(core, opdata): ``core(freqs, params, opdata)`` plus the
        operator dict on the Problem's device (built once)."""
        memo = getattr(self, "_fr_core_memo", None)
        if memo is None:
            memo = self._fr_core_memo = self._build_fr_core()
        return memo

    def _build_fr_core(self):
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
        return self._mixed_core(K_ref, ss, scale_vec)

    def _coarse_level(self, factor: float):
        """Mesh, free DOFs and constrained mask of the coarsened geometry —
        all the two-grid prolongation needs of the coarse level."""
        mesh = self.geometry.coarsened(factor).get_mesh()
        constrained, _ = _uvw_constraints(
            mesh, getattr(self.geometry, "clamped_labels", (1,)))
        return mesh, np.nonzero(~constrained)[0], constrained

    def _mixed_core(self, K_ref: np.ndarray, ss: np.ndarray,
                    scale_vec: np.ndarray):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from ..ops.band import (
            build_band_layout, build_rect_band, flat_to_band,
            permute_pattern, permute_vector, rect_band_tensor,
        )
        from ..ops.band_kernel import pack_band_tiles
        from ..ops.dense import inv_refined
        from ..ops.mg import _dinv_lmax, _pin_dead, build_prolongation
        from ..ops.mixed import band_basis_host, mixed_apply, mixed_sweep
        from ..ops.scatter import to_dense

        op = self.op
        n = op.n_free
        h = self.geometry.height
        dev = self.device

        # the RCM block-tridiagonal layout from 8192 DOF (below it the dense
        # GEMM preconditioner dominates and the band's blocks are tiny);
        # the dense inverse up to 12288 DOF, the two-grid above
        use_band = (self.operator_layout == "band"
                    or (self.operator_layout == "auto" and n >= 8192))
        precond = self.precond
        if precond == "auto":
            precond = "mg" if n > 12288 else "dense"
        if precond == "mg" and not use_band:
            raise NotImplementedError(
                "precond='mg' on the flat layout (operator_layout='flat', or "
                "'auto' below 8192 DOF) needs the flat multilevel "
                "preconditioner, which is not ported yet (ROADMAP Queue 1, "
                "item 14); the port's two-grid runs on the band layout.")
        basis_f32 = (precond == "dense" if self.basis_f32 is None
                     else bool(self.basis_f32))
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

        if precond == "mg":
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
                                   three_field=True)
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

        if self._given_opdata is not None:
            opdata = self._given_opdata
        else:
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

            def t64(a):
                return torch.as_tensor(np.asarray(a, np.float64), device=dev)

            W64, _ = band_basis_host(K_ref_eq, M_eq, rows_h, cols_h, n,
                                     omega_max=2.0 * np.pi * self.f_max)
            rows_d = torch.as_tensor(rows_h, dtype=torch.int64, device=dev)
            cols_d = torch.as_tensor(cols_h, dtype=torch.int64, device=dev)
            opdata = {
                "rows": rows_d,
                "cols": cols_d,
                "MIn": t64(M_eq),
                "fIn": t64(pvec(self.fInertia * scale_vec)),
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
                "W64": t64(W64),
            }
            if layout is not None:
                opdata["band_lin"] = torch.as_tensor(
                    layout.lin, dtype=torch.int64, device=dev)
            if precond == "mg":
                # the coarse Galerkin operator is too ill-conditioned for
                # any f32 factorization: invert it with a host f64 splu
                Kc_inv = spla.splu(Kc).solve(np.eye(Kc.shape[0]))
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
                    to_dense(t64(K_ref_eq), rows_d, cols_d, n))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self._inv_build_s = time.perf_counter() - t0

        if precond == "mg":
            # the f32 K_ref band of the preconditioner, packed once per
            # Problem into its nonzero tiles: every band_mv_f32 of every
            # sweep reads it
            t0 = time.perf_counter()
            pack = pack_band_tiles(opdata["mg_band0"], layout)
            if pack.vals.is_cuda:
                torch.cuda.synchronize(pack.vals.device)
            self._band_pack = pack
            self._pack_build_s = time.perf_counter() - t0

        material = self.material
        ki_prop = material.scalar_loss_factor
        ts = self.accelerometer.transverse_sensitivity
        freq_chunk = self._auto_freq_chunk()

        def assemble(freqs, params, od):
            omegas = 2.0 * math.pi * freqs
            (Are, Aim), (Bre, Bim), (Dre, Dim) = material.abd_split(params, h)
            Cre = torch.stack([Are, Bre, Dre])                  # (3, 6)
            Cim = torch.stack([Aim, Bim, Dim])
            K_re = torch.einsum("mk,mkn->n", Cre, od["ABD"])
            K_im = torch.einsum("mk,mkn->n", Cim, od["ABD"])
            bK_re = torch.einsum("mk,mkn->n", Cre, od["fABD"])
            bK_im = torch.einsum("mk,mkn->n", Cim, od["fABD"])
            B_re = bK_re[None, :] - (omegas ** 2)[:, None] * od["fIn"][None, :]
            B_im = bK_im[None, :].expand_as(B_re)
            return K_re, K_im, B_re, B_im, omegas

        def solve(K_re, K_im, B_re, B_im, omegas, od, adjoint):
            band = (None if layout is None
                    else {"layout": layout, "lin": od["band_lin"]})
            mg = None if precond != "mg" else {
                "tg_pack": pack, "dinv": od["mg_dinv"], "Pt": od["mg_Pt"],
                "Kc_inv": od["mg_Kcinv"], "slots": od["mg_slots"],
                "lmax": lmax, "rl": rl, "layout": layout}
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
                    adjoint=adjoint)

        def sweep(freqs, params, od):
            """Primal sweep (U_re, U_im), each (F, n) f64, outside any
            autograd graph."""
            K_re, K_im, B_re, B_im, omegas = assemble(freqs, params, od)
            return solve(K_re, K_im, B_re, B_im, omegas, od, False)

        def sweep_adj(freqs, params, od, G_re, G_im):
            """Adjoint sweep: conj(A) y = g per frequency, the transpose of
            the split-complex operator, for right-hand sides (F, n)."""
            K_re, K_im, _, _, omegas = assemble(freqs, params, od)
            return solve(K_re, K_im, G_re, G_im, omegas, od, True)

        def apply_res(freqs, params, od, U_re, U_im):
            """The residual map A(theta) U - b(theta) at fixed U, each
            (F, n) f64, differentiable in ``params`` (forward and reverse
            mode)."""
            K_re, K_im, B_re, B_im, omegas = assemble(freqs, params, od)
            AU_re, AU_im = mixed_apply(K_re, K_im, od["MIn"], omegas, U_re,
                                       U_im, od["rows"], od["cols"], n,
                                       ki_proportional=ki_prop)
            return AU_re - B_re, AU_im - B_im

        def readout(U_re, U_im, od):
            def mag2(rvec, r0):
                yr = U_re @ rvec + r0
                yi = U_im @ rvec
                return yr * yr + yi * yi

            u2 = mag2(od["ru"], od["r0"][0])
            v2 = mag2(od["rv"], od["r0"][1])
            w2 = mag2(od["rw"], od["r0"][2])
            return torch.sqrt(ts * ts * (u2 + v2) + w2)

        def core(freqs, params, od):
            """FRF magnitude (F,) f64 at ``freqs`` (F,) for ``params``, both
            f64 tensors on the operator data's device.  Differentiable in
            ``params``: the backward of the sweep is one adjoint sweep."""
            U_re, U_im = _ImplicitSweep.apply(params, freqs, od, core)
            return readout(U_re, U_im, od)

        # the pieces the adjoint Gauss-Newton Jacobian and the gradient need
        core.sweep_u = sweep
        core.sweep_adj = sweep_adj
        core.apply_res = apply_res
        core.readout_ui = readout
        return core, opdata

    def _reference_stiffness_flat(self) -> np.ndarray:
        """Flat (signed) Re K(theta_ref) data: equilibration scale source and
        the reference operator of the band basis and the preconditioner."""
        op = self.op
        if getattr(self, "parameters", None) is None:
            return sum(v for k, v in op.mats.items() if k[0] in "ABD")
        Av, Bv, Dv = self.material.reference_coeffs(
            np.asarray(self.parameters, np.float64), self.geometry.height)
        out = np.zeros(op.pattern.nnz)
        for i, s in enumerate(MODULI_INDICES):
            out += (Av[i] * op.mats["A" + s] + Bv[i] * op.mats["B" + s]
                    + Dv[i] * op.mats["D" + s])
        return out

    def _auto_freq_chunk(self) -> int | None:
        """Lanes per batch, bounding the live f64 FGMRES state to ~2 GB
        (None = one batch for small patterns)."""
        if self.freq_chunk is not None:
            return self.freq_chunk
        if self.op.pattern.nnz <= 300_000:
            return None
        per_lane = (4.0 * self.n_refine + 6.0) * self.n_free * 8.0
        return int(np.clip(
            2 ** np.floor(np.log2(max(2.0e9 / per_lane, 8.0))), 8, 64))

    def getFRFunction(self) -> Callable:
        """(freqs, params) -> FRF magnitude, an f64 tensor on the Problem's
        device.  The callable exposes ``.core`` and ``.opdata``."""
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
        fmax = float(np.max(np.asarray(freqs)))
        if fmax > self.f_max * 1.0001:
            warnings.warn(
                f"Sweep reaches {fmax:.1f} Hz but the mixed engine's band "
                f"basis was built for f_max={self.f_max:.1f} Hz; accuracy "
                "and refinement convergence degrade above the band. "
                "Recreate the Problem with f_max >= the sweep maximum.",
                RuntimeWarning)

    def solveForward(self, freqs: np.ndarray,
                     params: np.ndarray = None) -> torch.Tensor:
        """Forward FRF magnitude for a set of frequencies [Hz]
        (reference Problem.py:611-639), an f64 tensor on the device."""
        if params is None:
            params = self.parameters
        self._check_band(freqs)
        return self.getFRFunction()(freqs, params)

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
        (``optimize.optimize_gauss_newton``); the adjoint Jacobian, see
        :class:`ResidualFunction`."""
        assert np.shape(frequencies)[0] == np.shape(reference_fr)[0]
        self._check_band(frequencies)
        core, opdata = self.getFRCore()
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
        """Inverse solve from an initial guess (reference Problem.py:641-914)
        by Gauss-Newton ('gn' / 'gauss_newton') on the adjoint Jacobian.

        ``arg0`` is a 1-D start point: absolute, or with ``use_rel``
        relative corrections on the Problem's own parameters, theta_0 =
        (1 + arg0) * parameters.  ``use_scaling`` iterates on O(1)
        variables (theta / theta_0).  ``report`` prints and writes the
        text report, ``log`` the ``.npz`` history, both under
        ``utils.paths.get_output_dir()``.  Returns an :class:`optResult`
        with host numpy iterates.
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
        if compression[0]:
            raise NotImplementedError(
                "FRF compression (compression=(True, k)) is not ported yet "
                "(ROADMAP Queue 1, item F.17: io/compress.py).")
        if optimizer not in ("gn", "gauss_newton"):
            known = ("trust_region", "tr", "coord_descent", "cd",
                     "coord_descent_mem", "cd_mem", "grad_descent", "gd",
                     "newton", "lbfgs", "de", "shgo")
            if optimizer in known:
                raise NotImplementedError(
                    f"Optimizer {optimizer!r} is not ported yet (ROADMAP "
                    "Queue 1, item D); the port runs Gauss-Newton ('gn').")
            raise ValueError(f"Optimizer type `{optimizer}` is not supported!")

        guess = np.asarray(arg0, dtype=np.float64)
        if guess.ndim == 2:
            raise NotImplementedError(
                "A 2-D bounds box is the start of the global optimizers "
                "('de', 'shgo'), which are not ported yet (ROADMAP Queue 1, "
                "item D).")
        if guess.ndim != 1:
            raise ValueError("arg0 must be a 1-D start point or a 2-D bounds "
                             f"box; got ndim={guess.ndim}.")
        if use_rel:
            base = getattr(self, "parameters", None)
            if base is None:
                raise ValueError(
                    "use_rel=True reads arg0 as relative corrections on the "
                    "Problem's own parameter vector, but this Problem "
                    "carries none (material built without parameters).")
            factors = guess + 1.0
            start = np.asarray(base, np.float64) * factors
        else:
            factors = None
            start = guess
        if use_scaling:
            scaling_params = start
            x0 = factors if use_rel else np.ones_like(start)
        else:
            scaling_params = np.ones_like(start)
            x0 = start

        kind = {"MSE": "complex", "RMSE": "complex", "MSE_AFC": "afc",
                "MSE_LOG_AFC": "log_afc"}.get(loss_type)
        if kind is None:
            raise ValueError(f'Function type "{loss_type}" is not supported!')
        resfn = self.getResidualFunction(
            ref_fr[0], ref_fr[1], kind=kind,
            scaling_params=scaling_params if use_scaling else None)

        from ..optimize import optimize_gauss_newton

        t_start = time.perf_counter()
        result = optimize_gauss_newton(resfn, x0, **opt_kwargs)
        elapsed = (time.perf_counter() - t_start) / 60
        if use_scaling:
            result = result._replace(x=result.x * scaling_params)

        full_str = case_name + (default_uid() if uid is None else uid)
        if report:
            rel_err1 = rel_err2 = "Unknown"
            if getattr(self, "parameters", None) is not None:
                params0 = np.array(self.parameters)
                rel_err1 = (np.array(x0) * scaling_params - params0) / params0
                rel_err2 = (np.array(result.x) - params0) / params0

            def a2s(s):
                if isinstance(s, str):
                    return s
                return np.array2string(np.array(s), separator=", ",
                                       precision=5)

            f0 = result.f_history[0] if len(result.f_history) else float("nan")
            rep_str = (
                f"{self.accelerometer}\n{self.material}\n{self.geometry}\n"
                + extra_info
                + f"Starting parameters: {a2s(np.asarray(x0) * scaling_params)}.\n"
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
