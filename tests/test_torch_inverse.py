"""The port's inverse half (plate_inverse_problem_tpu_torch) held against the
JAX package on the CPU, on the small band + two-grid plate: ``sh_i``
refine = 1, n = 1466, 9 frequencies over 40-300 Hz (through the ~150 Hz
resonance), the start theta_0 = truth x (1.05, 1.02, 1.2).

Both sides run on the JAX operator data (``opdata_from_jax``: one band
basis, one pattern), with the reference FRF made once by the JAX package
at the truth.  The module compiles one JAX Jacobian, the scaled log_afc
r + J at theta_0: the afc residual and the four losses at theta_0 follow
from it in numpy (fr = |ref| exp(r_log), dfr/dtheta = fr J_log /
theta_0, each loss the mean of its per-frequency term of fr, as the JAX
``LossFunction`` defines it).  Tolerances:

* adjoint sweep: 3e-6 of a lane's max |Y| against JAX (the f32
  preconditioner rounds differently on the two sides, so the FGMRES
  iterates differ — the forward sweep's tolerance), 1e-6 against a host
  complex128 ``splu`` solve;
* residual map A(theta) U - b(theta): 1e-13 of each row's abs-sum
  sum_k |A_jk u_k| + |b_j| (f64 summation order);
* r to 3e-6 (log_afc; afc: of max |ref|), J to 1e-5 of max |J|;
* loss value and gradient: 1e-5 relative (against the JAX log_afc
  Jacobian chained through each loss's term);
* 2 J^T r / m against the MSE_LOG_AFC gradient within the port: 1e-8 of
  the gradient's max |component| (the two adjoint sweeps see right-hand
  sides that differ by a per-lane factor; the sweep scales every lane to
  max |b| = 1, so they differ only by rounding);
* three Gauss-Newton iterates: f_history to 1e-5, x to 1e-6 relative.
"""
import jax
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.optimize import (
    optimize_gauss_newton as jax_gauss_newton)
from plate_inverse_problem_tpu_torch.ops import mixed as tmixed
from plate_inverse_problem_tpu_torch.oracle import splu_adjoint
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)
MAT = dict(E=200e9, G=75e9, beta=0.003)
FREQS = np.linspace(40.0, 300.0, 9)
START = np.array([1.05, 1.02, 1.2])


def _port_problem(od):
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", **MAT)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), refine=1.0)
    return pt.Problem(geom, mat, acc, device="cpu", precond="mg",
                      operator_layout="band",
                      opdata=pt.opdata_from_jax(od, "cpu"))


@pytest.fixture(scope="module")
def setup():
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", **MAT)
    geom = pip.Geometry("sh_i", acc, pip.GeometryParams(*GP), refine=1.0)
    pj = pip.Problem(geom, mat, acc, engine="mixed", precond="mg",
                     operator_layout="band")
    truth = np.asarray(pj.parameters)
    ref = np.array(pj.getFRFunction()(FREQS, truth))
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    pp = _port_problem(od)
    pp.getFRCore()
    return pj, pp, truth, ref


@pytest.fixture(scope="module")
def jax_rj(setup):
    """JAX r and J: log_afc with the solveInverse scaling (theta_0, at
    x = 1), its object reused for the Gauss-Newton reference; from it, afc
    unscaled (at theta_0), and the FRF at theta_0 and its Jacobian (``fr``,
    ``dfr``) for the losses."""
    pj, _, truth, ref = setup
    th0 = truth * START
    rf = pj.getResidualFunction(FREQS, ref, kind="log_afc",
                                scaling_params=th0)
    r, J = (np.asarray(a) for a in rf.value_and_jac(np.ones(3)))
    fr = np.abs(ref) * np.exp(r)
    dfr = fr[:, None] * J / th0[None, :]
    return {"log_afc": (rf, (r, J)), "afc": (None, (fr - np.abs(ref), dfr)),
            "fr": fr, "dfr": dfr}


def _port_rf(setup, kind):
    _, pp, truth, ref = setup
    th0 = truth * START
    if kind == "log_afc":
        return pp.getResidualFunction(FREQS, ref, kind=kind,
                                      scaling_params=th0), np.ones(3)
    return pp.getResidualFunction(FREQS, ref, kind=kind), th0


@pytest.fixture(scope="module")
def adjoint_case(setup):
    """U at theta_0 and the log_afc readout gradient G = dr/dU (one
    pullback at the all-ones cotangent), from the port, in numpy."""
    _, pp, truth, ref = setup
    core, od = pp.getFRCore()
    th = torch.as_tensor(truth * START)
    freqs = torch.as_tensor(FREQS)
    U_re, U_im = core.sweep_u(freqs, th, od)
    Ur = U_re.clone().requires_grad_(True)
    Ui = U_im.clone().requires_grad_(True)
    r = torch.log(core.readout_ui(Ur, Ui, od)) - torch.log(
        torch.as_tensor(ref))
    G_re, G_im = torch.autograd.grad(r, (Ur, Ui), torch.ones_like(r))
    return th, (U_re.numpy(), U_im.numpy()), (G_re.numpy(), G_im.numpy())


def _lane_err(a, b):
    """Per-lane max |a - b| over the lane's max |b| (complex pairs)."""
    d = np.abs((a[0] - b[0]) + 1j * (a[1] - b[1])).max(axis=1)
    return d / np.abs(b[0] + 1j * b[1]).max(axis=1)


# ---------------------------------------------------------------------------
# (1) the adjoint sweep
# ---------------------------------------------------------------------------

def test_adjoint_sweep_matches_jax_and_oracle(setup, adjoint_case):
    pj, pp, _, _ = setup
    th, _, (G_re, G_im) = adjoint_case
    core, od = pp.getFRCore()
    Yt = tuple(y.numpy() for y in core.sweep_adj(
        torch.as_tensor(FREQS), th, od, torch.as_tensor(G_re),
        torch.as_tensor(G_im)))
    assert Yt[0].shape == (FREQS.size, pp.n_free)
    assert np.all(np.isfinite(Yt[0])) and np.all(np.isfinite(Yt[1]))
    core_j, od_j = pj.getFRCore()
    Yj = tuple(np.asarray(y) for y in jax.jit(core_j.sweep_adj)(
        FREQS, th.numpy(), od_j, G_re, G_im))
    assert np.all(_lane_err(Yt, Yj) <= 3e-6)
    Yo = splu_adjoint(pp, FREQS, G_re, G_im, th.numpy())
    assert np.all(_lane_err(Yt, Yo) <= 1e-6)
    assert np.all(_lane_err(Yj, Yo) <= 1e-6)


def test_adjoint_sweep_scale_free_lanes(setup, adjoint_case):
    """A lane whose right-hand side is 1e-200 times another's converges to
    1e-200 times its solution (no underflow, no NaN); an all-zero lane
    gives exactly zero."""
    _, pp, _, _ = setup
    th, _, (G_re, G_im) = adjoint_case
    core, od = pp.getFRCore()
    i = int(np.argmax(np.abs(G_re).max(axis=1)))
    f = np.concatenate([FREQS, FREQS[[i, i]]])
    g_re = np.concatenate([G_re, 1e-200 * G_re[[i]], 0 * G_re[[i]]])
    g_im = np.concatenate([G_im, 1e-200 * G_im[[i]], 0 * G_im[[i]]])
    Y_re, Y_im = (y.numpy() for y in core.sweep_adj(
        torch.as_tensor(f), th, od, torch.as_tensor(g_re),
        torch.as_tensor(g_im)))
    assert np.all(np.isfinite(Y_re)) and np.all(np.isfinite(Y_im))
    big = Y_re[i] + 1j * Y_im[i]
    tiny = (Y_re[-2] + 1j * Y_im[-2]) * 1e200
    assert np.abs(big).max() > 0
    assert np.abs(tiny - big).max() <= 1e-9 * np.abs(big).max()
    assert not Y_re[-1].any() and not Y_im[-1].any()


# ---------------------------------------------------------------------------
# (2) the residual map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_apply_res_matches_jax(setup, adjoint_case, monkeypatch, chunked):
    """A(theta) U - b(theta) at fixed U; ``chunked`` shrinks the apply's
    memory budget and nnz segment so the lanes go in chunks of 8 (a
    ragged tail of 1) and the pattern in 7 segments."""
    pj, pp, _, _ = setup
    th, (U_re, U_im), _ = adjoint_case
    core, od = pp.getFRCore()
    if chunked:
        monkeypatch.setattr(tmixed, "_APPLY_BUDGET", 1.0)
        monkeypatch.setattr(tmixed, "_RES_SEG", 5000)
    Rt = tuple(x.numpy() for x in core.apply_res(
        torch.as_tensor(FREQS), th, od, torch.as_tensor(U_re),
        torch.as_tensor(U_im)))
    core_j, od_j = pj.getFRCore()
    Rj = tuple(np.asarray(x) for x in jax.jit(core_j.apply_res)(
        FREQS, th.numpy(), od_j, U_re, U_im))
    # row abs-sums sum_k |A_jk u_k| + |b_j| from the same flat data
    K_re, K_im, B_re, B_im, om = (x.numpy() for x in _assemble(pp, th))
    rows, cols = od["rows"].numpy(), od["cols"].numpy()
    absU = np.abs(U_re + 1j * U_im)[:, cols]
    absA = np.abs((K_re + 1j * K_im)[None, :]
                  - (om ** 2)[:, None] * od["MIn"].numpy()[None, :])
    scale = np.zeros((FREQS.size, pp.n_free))
    np.add.at(scale.T, rows, (absA * absU).T)
    scale += np.abs(B_re + 1j * B_im)
    err = np.abs((Rt[0] - Rj[0]) + 1j * (Rt[1] - Rj[1]))
    assert np.all(err <= 1e-13 * scale)


def _assemble(pp, th):
    """K_re, K_im, B_re, B_im, omegas at ``th`` (the core's assembly)."""
    od = pp.getFRCore()[1]
    om = 2 * np.pi * torch.as_tensor(FREQS)
    (Are, Aim), (Bre, Bim), (Dre, Dim) = pp.material.abd_split(
        th, pp.geometry.height)
    Cre = torch.stack([Are, Bre, Dre])
    Cim = torch.stack([Aim, Bim, Dim])
    K_re = torch.einsum("mk,mkn->n", Cre, od["ABD"])
    K_im = torch.einsum("mk,mkn->n", Cim, od["ABD"])
    B_re = (torch.einsum("mk,mkn->n", Cre, od["fABD"])[None, :]
            - (om ** 2)[:, None] * od["fIn"][None, :])
    B_im = torch.einsum("mk,mkn->n", Cim, od["fABD"])[None, :].expand_as(B_re)
    return K_re, K_im, B_re, B_im, om


# ---------------------------------------------------------------------------
# (3) r and the adjoint Jacobian; (5) 2 J^T r / m = the loss gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["log_afc", "afc"])
def test_value_and_jac_matches_jax(setup, jax_rj, kind):
    _, _, _, ref = setup
    rf, x = _port_rf(setup, kind)
    assert rf.jac_mode == "adjoint"
    r, J = rf.value_and_jac(x)
    r, J = r.numpy(), J.numpy()
    rj, Jj = jax_rj[kind][1]
    assert r.shape == (FREQS.size,) and J.shape == (FREQS.size, 3)
    r_scale = 1.0 if kind == "log_afc" else np.abs(ref).max()
    assert np.abs(r - rj).max() <= 3e-6 * r_scale
    assert np.abs(J - Jj).max() <= 1e-5 * np.abs(Jj).max()
    # the residual alone is the value of value_and_jac
    np.testing.assert_array_equal(rf(x).numpy(), r)


def test_gauss_newton_gradient_is_loss_gradient(setup):
    _, pp, truth, ref = setup
    th0 = truth * START
    rf, x = _port_rf(setup, "log_afc")
    r, J = rf.value_and_jac(x)
    g_gn = (2.0 * J.T @ r / r.numel()).numpy()
    g = pp.getLossFunction(FREQS, ref, "MSE_LOG_AFC", th0).grad(x).numpy()
    assert np.abs(g_gn - g).max() <= 1e-8 * np.abs(g).max()


# ---------------------------------------------------------------------------
# (4) the losses
# ---------------------------------------------------------------------------

def _loss_term(func_type, fr, ref):
    """The JAX ``LossFunction``'s per-frequency term of a real FRF ``fr``
    and its derivative in fr."""
    d_re, d_im = fr - ref.real, -ref.imag
    if func_type == "MSE":
        return d_re ** 2 + d_im ** 2, 2.0 * d_re
    if func_type == "RMSE":
        a2 = np.abs(ref) ** 2
        return (d_re ** 2 + d_im ** 2) / a2, 2.0 * d_re / a2
    if func_type == "MSE_AFC":
        d = fr - np.abs(ref)
        return d ** 2, 2.0 * d
    d = np.log(fr) - np.log(np.abs(ref))          # MSE_LOG_AFC
    return d ** 2, 2.0 * d / fr


@pytest.mark.parametrize("func_type", ["MSE", "RMSE", "MSE_AFC",
                                       "MSE_LOG_AFC"])
def test_loss_value_and_grad_match_jax(setup, jax_rj, func_type):
    _, pp, truth, ref = setup
    th0 = truth * START
    term, dterm = _loss_term(func_type, jax_rj["fr"], ref)
    vj = float(term.mean())
    gj = (dterm[:, None] * jax_rj["dfr"]).mean(axis=0)
    lf = pp.getLossFunction(FREQS, ref, func_type)
    v, g = lf.value_and_grad(th0)
    assert abs(float(v) - vj) <= 1e-5 * abs(vj)
    assert np.all(np.abs(g.numpy() - gj) <= 1e-5 * np.abs(gj))
    assert float(lf(th0)) == float(v)
    np.testing.assert_array_equal(lf.grad(th0).numpy(), g.numpy())


# ---------------------------------------------------------------------------
# (6) Gauss-Newton through solveInverse; (7) its report and log
# ---------------------------------------------------------------------------

class _ThroughJac:
    """A JAX ``ResidualFunction`` whose residual is read from its compiled
    r + J (the fixture's): the Gauss-Newton reference's trial residuals
    need no second compile of the sweep."""

    def __init__(self, rf):
        self.value_and_jac = rf.value_and_jac

    def __call__(self, x):
        return self.value_and_jac(x)[0]


def test_solve_inverse_gn_matches_jax(setup, jax_rj):
    """The port's ``solveInverse(..., 'gn', use_scaling=True)`` against the
    JAX package's Gauss-Newton on the residual its solveInverse builds
    (log_afc scaled by theta_0, from x = 1)."""
    _, pp, truth, ref = setup
    th0 = truth * START
    res = pp.solveInverse(th0, "MSE_LOG_AFC", "gn", ref_fr=(FREQS, ref),
                          use_scaling=True, N_steps=3, report=False,
                          log=False)
    rj = jax_gauss_newton(_ThroughJac(jax_rj["log_afc"][0]), np.ones(3),
                          N_steps=3)
    assert res.niter == rj.niter and res.status == rj.status
    fj = np.asarray(rj.f_history)
    assert len(res.f_history) == fj.size == 3
    assert np.all(np.abs(np.asarray(res.f_history) - fj) <= 1e-5 * fj)
    xj = np.asarray(rj.x) * th0
    assert np.all(np.abs(res.x - xj) <= 1e-6 * np.abs(xj))
    assert np.all(np.diff(res.f_history) < 0)


def test_solve_inverse_writes_report_and_log(setup, tmp_path, monkeypatch):
    _, pp, truth, ref = setup
    monkeypatch.setenv("PIP_TPU_OUTPUT_DIR", str(tmp_path))
    res = pp.solveInverse(0.05 * np.ones(3), "MSE_LOG_AFC", "gauss_newton",
                          ref_fr=(FREQS, ref), use_rel=True, N_steps=1,
                          case_name="case_", uid="u1")
    text = (tmp_path / "case_u1.txt").read_text()
    assert "Optimizer type: gauss_newton." in text
    assert "Isotropic material with" in text
    log = np.load(tmp_path / "case_u1.npz")
    assert log["x"].shape == (2, 3) and log["f"].shape == (2,)
    np.testing.assert_allclose(log["x"][0], truth * 1.05, rtol=1e-15)
    np.testing.assert_array_equal(log["x"][-1], res.x)
    assert int(log["k"][0]) == res.niter


# ---------------------------------------------------------------------------
# (8) unknown options raise
# ---------------------------------------------------------------------------

def test_unknown_inverse_options_raise_value_error(setup):
    _, pp, truth, ref = setup
    with pytest.raises(ValueError):
        pp.getResidualFunction(FREQS, ref, kind="phase")
    with pytest.raises(ValueError):
        pp.getLossFunction(FREQS, ref, "L1")
    with pytest.raises(ValueError):
        pp.solveInverse(truth, "MSE_LOG_AFC", "simplex", ref_fr=(FREQS, ref),
                        report=False, log=False)

