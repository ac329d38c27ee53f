"""The port's modal and direct engines (plate_inverse_problem_tpu_torch
``ops/spectral.py``, ``ops/sweep.py`` and their cores in
``models/problem.py``) held against the JAX package's on the CPU.

The plate is the JAX tests' small one: ``symm`` ny = 1, isotropic steel,
AP1030 (n = 420 on the 3-field path, 270 on the pure-bending path), 10
frequencies over 40-600 Hz; the JAX direct engine at ``chunk=4``.  The port
runs K3's plain version on the CPU.  Tolerances, each relative:

* FRF against the same JAX engine: 1e-9 (both exact f64 solves; the two
  differ by rounding only, 6e-12 to 6e-11 measured);
* loss gradient, forward-mode Jacobian and Hessian against ``jax.grad``,
  JAX's fwd ``value_and_jac`` and ``LossFunction.hessian`` through the same
  engine: 1e-8 of the largest entry (1.5e-10 to 2e-10 measured);
* the splu oracle of a frequency-dependent material against the
  constant-beta oracle at beta pinned to beta(omega_i): 1e-12 (the same
  refined LU solve);
* the golden constants of tests/test_golden.py through the port's modal
  engine: 1e-8, that file's own tolerance;
* ``chunk`` changes which frequencies' matrices are built together,
  never a lane's arithmetic (each matrix is factored alone, on the card
  too, where phase 11 (a) of ``chip_smoke.py`` gates it): bit for bit.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.ops.spectral import modal_basis_from_flat
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, 10e-3, None)     # tests/test_problem.py
MAT = dict(E=200e9, G=75e9, beta=0.003)
D4 = dict(E1=210e9, E2=200e9, G12=75e9, nu12=0.33, b1=0.003, b2=0.003,
          b3=0.004, b4=0.0)
FREQS = np.linspace(40.0, 600.0, 10)
THETA = np.array([1.03, 0.98, 1.1])          # theta / truth of the derivatives
FRF_TOL = 1e-9
DERIV_TOL = 1e-8
OMEGA_REF = 2.0 * np.pi * 300.0


def _parts(mod, mat=None, accel=True, ny=1):
    acc = mod.Accelerometer("AP1030")
    geom = mod.Geometry("symm", acc, mod.GeometryParams(*GP), ny=ny)
    if mat is None:
        mat = mod.get_material(7920.0, "isotropic", **MAT)
    return geom, mat, acc if accel else None


_PAIRS = {}


def _pair(engine, accel=True):
    """(JAX Problem, its FRF at FREQS, port Problem) on the small plate,
    one per engine and path for the whole module."""
    key = (engine, accel)
    if key not in _PAIRS:
        pj = pip.Problem(*_parts(pip, accel=accel), engine=engine, chunk=4)
        yj = np.asarray(pj.getFRFunction()(FREQS, np.asarray(pj.parameters)))
        pp = pt.Problem(*_parts(pt, accel=accel), engine=engine,
                        device="cpu")
        _PAIRS[key] = (pj, yj, pp)
    return _PAIRS[key]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))


def _rel_max(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


class _FreqDepJax(pip.Isotropic):
    """tests/test_problem.py's omega-dependent damping, beta (1 + omega /
    omega_ref), in the JAX package."""

    def get_D_transform(self, h):
        base = super().get_D_transform(h)

        def _t(params, omega=0.0):
            b = params[2] * (1.0 + omega / OMEGA_REF)
            return base(jnp.stack([params[0], params[1], b]), 0.0)

        return _t

    def get_ABD_transform(self, h):
        base = super().get_ABD_transform(h)

        def _t(params, omega=0.0):
            b = params[2] * (1.0 + omega / OMEGA_REF)
            return base(jnp.stack([params[0], params[1], b]), 0.0)

        return _t

    @property
    def scalar_loss_factor(self):
        return False


class _FreqDepPort(pt.Isotropic):
    """The same material in the port: its split transforms at omega."""

    def abd_split(self, params, h, omega=0.0):
        b = params[2] * (1.0 + omega / OMEGA_REF)
        return super().abd_split(torch.stack([params[0], params[1], b]), h)

    def d_split(self, params, h, omega=0.0):
        b = params[2] * (1.0 + omega / OMEGA_REF)
        return super().d_split(torch.stack([params[0], params[1], b]), h)


@pytest.mark.parametrize("accel", [True, False], ids=["3field", "bending"])
@pytest.mark.parametrize("engine", ["modal", "direct"])
def test_frf_matches_jax(engine, accel):
    pj, yj, pp = _pair(engine, accel)
    assert pp.n_free == pj.n_free == (420 if accel else 270)
    y = pp.solveForward(FREQS).numpy()
    core = pp.getFRCore()[0]
    assert core.engine == engine and pp._resolve_engine() == engine
    assert y.dtype == (np.float64 if accel else np.complex128)
    assert _rel(y, yj) <= FRF_TOL


def test_engine_none_resolves_as_jax():
    """engine=None on a CPU device: 'modal' for a scalar loss factor,
    'direct' for per-modulus loss factors (OrthotropicD4), as JAX
    ``Problem._engine`` on its CPU backend; the D4 FRF matches JAX's direct
    engine.  ``diagnoseSweep`` raises ValueError on a non-mixed engine,
    and only the mixed engine warns past f_max."""
    mj = pip.get_material(7920.0, "orthotropic_d4", **D4)
    pj = pip.Problem(*_parts(pip, mj), chunk=4)
    assert pj._engine() == "direct"
    yj = np.asarray(pj.getFRFunction()(FREQS, np.asarray(pj.parameters)))
    pp = pt.Problem(*_parts(pt, pt.get_material(7920.0, "orthotropic_d4",
                                                **D4)),
                    engine=None, device="cpu")
    assert pp._engine() == pp._resolve_engine() == "direct"
    assert _rel(pp.solveForward(FREQS).numpy(), yj) <= FRF_TOL
    iso = pt.Problem(*_parts(pt), engine=None, device="cpu")
    assert iso._engine() == "modal"
    assert pt.Problem(*_parts(pt), engine=None)._engine() == "mixed"  # cuda
    pm = _pair("modal")[2]
    with pytest.raises(ValueError, match="diagnoseSweep applies to the "
                                         "iterative mixed engine"):
        pm.diagnoseSweep(FREQS)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pm._check_band([pm.f_max * 2.0])


def test_frequency_dependent_material():
    """A frequency-dependent material asked for with engine='modal' warns
    and runs the direct engine, on both paths, matching the JAX package's
    own fallback; its splu oracle evaluates the transform at each
    frequency, equal to the constant-beta oracle at beta(omega_i)."""
    for accel in (True, False):
        with pytest.warns(RuntimeWarning, match="frequency-dependent"):
            pj = pip.Problem(*_parts(pip, _FreqDepJax(7920.0, **MAT),
                                     accel), engine="modal", chunk=4)
            yj = np.asarray(pj.getFRFunction()(FREQS,
                                               np.asarray(pj.parameters)))
        pp = pt.Problem(*_parts(pt, _FreqDepPort(7920.0, **MAT), accel),
                        engine="modal", device="cpu")
        assert pp._resolve_engine() == "direct"
        with pytest.warns(RuntimeWarning, match="frequency-dependent"):
            core = pp.getFRCore()[0]
        assert core.engine == "direct"
        y = pp.solveForward(FREQS).numpy()
        assert _rel(y, yj) <= FRF_TOL
    # the per-frequency oracle (on the pure-bending Problem pp)
    theta = np.asarray(pp.parameters)
    for f in FREQS[[1, 6]]:
        b_i = MAT["beta"] * (1.0 + 2.0 * np.pi * f / OMEGA_REF)
        pin = pt.Problem(*_parts(pt, pt.get_material(
            7920.0, "isotropic", E=MAT["E"], G=MAT["G"], beta=b_i), False),
            engine="direct", device="cpu")
        ref = splu_frf(pin, [f], [theta[0], theta[1], b_i])
        assert _rel(splu_frf(pp, [f]), ref) <= 1e-12
    assert _rel(y[[1, 6]], splu_frf(pp, FREQS[[1, 6]])) <= FRF_TOL


@pytest.mark.parametrize("engine", ["modal", "direct"])
def test_loss_grad_matches_jax(engine, monkeypatch):
    """The gradient (a primal and an adjoint sweep) against ``jax.grad``;
    on the direct engine the forward-mode r + J, whose tangent sweep runs
    p x F lanes, factors each distinct frequency once a sweep (2 F LUs)."""
    pj, yj, pp = _pair(engine)
    th = np.asarray(pp.parameters) * THETA
    lj = pj.getLossFunction(FREQS, yj, "MSE_LOG_AFC")
    gj = np.asarray(jax.grad(lj)(jnp.asarray(th)))
    v, g = pp.getLossFunction(FREQS, yj, "MSE_LOG_AFC").value_and_grad(th)
    assert abs(float(v) - float(lj(jnp.asarray(th)))) <= 1e-9 * float(v)
    assert _rel_max(g.numpy(), gj) <= DERIV_TOL
    if engine == "direct":
        sizes = []
        lu = torch.linalg.lu_factor

        def counted(A, *a, **k):
            sizes.append(A.shape[0])
            return lu(A, *a, **k)

        monkeypatch.setattr(torch.linalg, "lu_factor", counted)
        pp.getResidualFunction(FREQS, yj, kind="log_afc").value_and_jac(th)
        assert sum(sizes) == 2 * FREQS.size


def test_fwd_jacobian_matches_jax():
    """ResidualFunction on the modal engine: 'auto' resolves to 'fwd' (no
    public adjoint hooks, as in the JAX package), r and J match JAX's
    forward-mode ones, 'adjoint' raises the JAX package's ValueError, and
    the whole call builds the modal basis once."""
    pj, yj, pp = _pair("modal")
    th = np.asarray(pp.parameters) * THETA
    rj = pj.getResidualFunction(FREQS, yj * 1.1, kind="log_afc")
    r_j, J_j = (np.asarray(a) for a in rj.value_and_jac(jnp.asarray(th)))
    rf = pp.getResidualFunction(FREQS, yj * 1.1, kind="log_afc")
    assert rf.jac_mode == rj.jac_mode == "fwd"
    builds = pp._modal_builds
    r, J = (a.numpy() for a in rf.value_and_jac(th))
    assert pp._modal_builds - builds <= 1
    assert _rel_max(r, r_j) <= DERIV_TOL and _rel_max(J, J_j) <= DERIV_TOL
    with pytest.raises(ValueError, match="jac_mode='adjoint' needs"):
        pp.getResidualFunction(FREQS, yj, kind="log_afc", jac_mode="adjoint")


def test_modal_hessian_matches_jax():
    pj, yj, pp = _pair("modal")
    th = np.asarray(pp.parameters) * THETA
    Hj = np.asarray(pj.getLossFunction(FREQS, yj, "MSE_LOG_AFC").hessian(
        jnp.asarray(th)))
    H = pp.getLossFunction(FREQS, yj, "MSE_LOG_AFC").hessian(th).numpy()
    assert _rel_max(H, Hj) <= DERIV_TOL


def test_n_modes_and_chunk():
    """n_modes truncates the modal basis as the JAX package does (an
    approximation: 40 of 420 modes move the FRF by ~4e-3, and the port
    follows JAX's truncated result); chunk=3 and chunk=16 give the direct
    sweep the same bits; the JAX package's block-Jacobi eigh (a TPU
    workaround) raises."""
    pj = pip.Problem(*_parts(pip), engine="modal", n_modes=40)
    yj = np.asarray(pj.getFRFunction()(FREQS, np.asarray(pj.parameters)))
    pp = pt.Problem(*_parts(pt), engine="modal", n_modes=40, device="cpu")
    y = pp.solveForward(FREQS).numpy()
    assert _rel(y, yj) <= FRF_TOL
    assert _rel(y, _pair("modal")[1]) > 1e-4
    fr = [pt.Problem(*_parts(pt), engine="direct", chunk=c,
                     device="cpu").solveForward(FREQS).numpy()
          for c in (3, 16)]
    assert np.array_equal(fr[0], fr[1])
    od = pp.getFRCore()[1]
    with pytest.raises(ValueError, match="do not port"):
        modal_basis_from_flat(od["MIn"], od["MIn"], od["rows"], od["cols"],
                              pp.n_free, method="jacobi")


def test_golden_through_modal():
    """tests/test_golden.py's three constants (ny = 2 'symm' plate, 50
    points) through the port's modal engine, the JAX package's CPU
    default."""
    from test_golden import (GOLDEN_PERTURBED_SUM, GOLDEN_SYMM_FR_SUM,
                             GOLDEN_UNSYMM_FR_SUM)

    freqs = np.linspace(40, 600, 50)
    p = pt.Problem(*_parts(pt, ny=2), engine=None, device="cpu")
    assert p._engine() == "modal"
    q = pt.Problem(*_parts(pt, accel=False, ny=2), engine=None, device="cpu")
    sums = (np.abs(p.solveForward(freqs).numpy()).sum(),
            np.abs(q.solveForward(freqs).numpy()).sum(),
            np.abs(p.solveForward(freqs, (np.array([0.1, 0.1, 0.2]) + 1)
                                  * p.parameters).numpy()).sum())
    np.testing.assert_allclose(
        sums, [GOLDEN_UNSYMM_FR_SUM, GOLDEN_SYMM_FR_SUM,
               GOLDEN_PERTURBED_SUM], rtol=1e-8)
