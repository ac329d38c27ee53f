"""Problem: geometry + material + accelerometer -> FRF sweep on a device.

Port of the JAX package's ``models/problem.py`` for the band tier of the
mixed engine: the 3-field (laminate) path, the RCM block-tridiagonal f64
operator and the two-grid f32 preconditioner.  Operator data is a plain
dict of tensors under the JAX opdata's key names; ``getFRCore`` returns a
plain function of (freqs, params, opdata).

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
from .accelerometer import Accelerometer
from .geometry import Geometry
from .materials import Material


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
        precond: str = "auto",          # 'mg' (two-grid); 'dense' waits
        mg_coarse_max: int = 11500,     # sets the coarsening factor
        freq_chunk: int | None = None,  # lanes per batch (None = auto)
        operator_layout: str = "auto",  # 'band'; 'flat' waits
        basis: str = "arpack",          # how the band basis is computed
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
        from ..ops.mg import _dinv_lmax, _pin_dead, build_prolongation
        from ..ops.mixed import band_basis_host, mixed_sweep

        op = self.op
        n = op.n_free
        h = self.geometry.height
        dev = self.device

        use_band = (self.operator_layout == "band"
                    or (self.operator_layout == "auto" and n >= 8192))
        if not use_band:
            raise NotImplementedError(
                "operator_layout='flat' (and 'auto' below 8192 DOF) is not "
                "ported yet (ROADMAP Queue 1, items 4-6: the dense tier).")
        precond = self.precond
        if precond == "auto":
            precond = "mg" if n > 12288 else "dense"
        if precond == "dense":
            raise NotImplementedError(
                "The dense f32 preconditioner (precond='dense', and 'auto' "
                "at or below 12288 DOF) is not ported yet (ROADMAP Queue 1, "
                "item 5).")
        layout = build_band_layout(op.pattern.rows, op.pattern.cols, n)
        rows_h, cols_h = permute_pattern(layout, op.pattern.rows,
                                         op.pattern.cols)

        def pvec(v, axis=-1):
            return permute_vector(layout, v, axis=axis)

        self._band_layout = layout
        K_ref_eq = K_ref * ss
        M_eq = self.MInertia * ss

        # ---- band tier two-grid: one coarse level, aimed directly at the
        # dense-invertible size (n scales ~ factor^-2)
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

            lin = torch.as_tensor(layout.lin, dtype=torch.int64, device=dev)
            # the coarse Galerkin operator is too ill-conditioned for any
            # f32 factorization: invert it with a host f64 splu
            Kc_inv = spla.splu(Kc).solve(np.eye(Kc.shape[0]))
            W64, _ = band_basis_host(K_ref_eq, M_eq, rows_h, cols_h, n,
                                     omega_max=2.0 * np.pi * self.f_max)
            opdata = {
                "rows": torch.as_tensor(rows_h, dtype=torch.int64, device=dev),
                "cols": torch.as_tensor(cols_h, dtype=torch.int64, device=dev),
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
                "band_lin": lin,
                "Kref64": t64(K_ref_eq),
                "mg_band0": flat_to_band(
                    torch.as_tensor(K_ref_eq, dtype=F32, device=dev),
                    layout, lin),
                "mg_dinv": torch.as_tensor(dinv, dtype=F32, device=dev),
                "mg_Pt": rect_band_tensor(rl, dev),
                "mg_slots": torch.as_tensor(rl.slots, dtype=torch.int64,
                                            device=dev),
                "mg_Kcinv": torch.as_tensor(Kc_inv, dtype=F32, device=dev),
            }

        # the f32 K_ref band of the preconditioner, packed once per Problem
        # into its nonzero tiles: every band_mv_f32 of every sweep reads it
        t0 = time.perf_counter()
        pack = pack_band_tiles(opdata["mg_band0"], layout)
        if pack.vals.is_cuda:
            torch.cuda.synchronize(pack.vals.device)
        self._band_pack = pack
        self._pack_build_s = time.perf_counter() - t0

        material = self.material
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

        def sweep(freqs, params, od):
            K_re, K_im, B_re, B_im, omegas = assemble(freqs, params, od)
            return mixed_sweep(
                K_re, K_im, od["MIn"], B_re, B_im, omegas,
                od["rows"], od["cols"], n, od["W64"],
                band={"layout": layout, "lin": od["band_lin"]},
                mg={"tg_pack": pack, "dinv": od["mg_dinv"],
                    "Pt": od["mg_Pt"], "Kc_inv": od["mg_Kcinv"],
                    "slots": od["mg_slots"], "lmax": lmax, "rl": rl,
                    "layout": layout},
                n_refine=self.n_refine, refine_tol=self.refine_tol,
                freq_chunk=freq_chunk,
                ki_proportional=material.scalar_loss_factor,
                k_cycle=self.k_cycle)

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
            f64 tensors on the operator data's device."""
            U_re, U_im = sweep(freqs, params, od)
            return readout(U_re, U_im, od)

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
