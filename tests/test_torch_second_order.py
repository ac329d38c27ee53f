"""The port's loss Hessian, second-order and global optimizers and
``getModePicture`` (plate_inverse_problem_tpu_torch) held against the JAX
package on the CPU.

The plate is the JAX suite's ``symm`` ny = 1 strip (isotropic steel),
on both paths: the 3-field path with the AP1030 accelerometer (n = 420)
and the pure-bending path without it (n = 270), 9 frequencies over
40-300 Hz (through the ~150 Hz resonance), theta_0 = truth x (1.05, 1.02,
1.2), variables x = theta / theta_0.  Both sides run the mixed engine on
the JAX package's operator data (``opdata_from_jax``: one band basis),
against the JAX package's FRF at the truth.  The module compiles one JAX
second derivative per path, d^2 fr / dx^2 with d fr / dx beside it (the
implicit-diff forward mode twice through the sweep): the value, gradient
and Hessian of each of the four losses follow from it in numpy, as the
JAX ``LossFunction`` defines each (the mean of a per-frequency term of
fr); MSE_LOG_AFC's is also held against the JAX ``LossFunction.hessian``
itself on the 3-field path.  (The JAX ``engine="direct"`` would be an
exact oracle, but under the suite's CPU load it runs 30-60x slower than
alone; the mixed engine is ~1e-9 off the exact solve here.)  Tolerances:

* loss value 1e-8 relative, gradient 1e-7 and Hessian 1e-6 of their max
  |entry| (the two sides' sweeps agree to ~1e-9; the Hessian's tangent
  solves round differently in their f32 preconditioner);
* the Hessian's asymmetry 1e-8 of its max (the tangent and tangent-adjoint
  solves' own error);
* through ``solveInverse``: the trust-region step against the JAX
  package's ``solve_trust_region_model`` on the port's model at x0 to
  1e-10, a Newton step against its formula; each method's loss falls and
  the trust region reaches the truth to 1e-6;
* ``de`` / ``shgo`` on a 2-D box: the same points as the JAX package's
  runs to 1e-6 relative (the same seeded population; the two losses
  differ by ~1e-9, far below any of DE's comparisons), the final loss to
  1e-4 relative (what 1e-6 in x allows at that loss);
* ``getModePicture``'s vertex |w|: 1e-9 relative to JAX's (one LU solve
  each, scipy's and JAX's own; measured 1.6e-10).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.optimize import (
    solve_trust_region_model as jax_tr_model)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

matplotlib.use("Agg")

FREQS = np.linspace(40.0, 300.0, 9)
START = np.array([1.05, 1.02, 1.2])
PATHS = ("accel", "symm")
LOSSES = ("MSE", "RMSE", "MSE_AFC", "MSE_LOG_AFC")


def _parts(mod, path):
    acc = mod.Accelerometer("AP1030")
    geom = mod.Geometry("symm", acc,
                        mod.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                        ny=1)
    mat = mod.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    return geom, mat, acc if path == "accel" else None


def _jax_derivatives(pj, th0):
    """fr, dfr / dx (F, p) and d^2 fr / dx^2 (F, p, p) at x = 1 from the
    JAX package (one compile)."""
    fr_fn = pj.getFRFunction()

    def fr(x):
        return fr_fn(FREQS, x * th0)

    def d1(x):
        J = jax.jacfwd(fr)(x)
        return J, J

    x1 = jnp.ones(th0.size)
    J2, J1 = jax.jacfwd(d1, has_aux=True)(x1)
    return (np.asarray(fr(x1)).astype(complex), np.asarray(J1).astype(complex),
            np.asarray(J2).astype(complex))


def _loss_oracle(loss_type, derivs, ref):
    """(value, gradient, Hessian) of a loss type, the mean of its
    per-frequency term of fr, by the chain rule from the JAX derivatives."""
    fr, J1, J2 = derivs
    a, b = fr.real, fr.imag
    a1, b1, a2, b2 = J1.real, J1.imag, J2.real, J2.imag
    ref = np.asarray(ref).astype(complex)

    def outer(u):
        return u[:, :, None] * u[:, None, :]

    if loss_type in ("MSE", "RMSE"):
        w = np.ones(fr.size) if loss_type == "MSE" else 1 / np.abs(ref) ** 2
        da, db = a - ref.real, b - ref.imag
        t = w * (da ** 2 + db ** 2)
        g = 2 * w[:, None] * (da[:, None] * a1 + db[:, None] * b1)
        H = 2 * w[:, None, None] * (outer(a1) + da[:, None, None] * a2
                                    + outer(b1) + db[:, None, None] * b2)
        return t.mean(), g.mean(0), H.mean(0)
    m = np.abs(fr)
    m1 = (a[:, None] * a1 + b[:, None] * b1) / m[:, None]
    m2 = ((outer(a1) + a[:, None, None] * a2 + outer(b1)
           + b[:, None, None] * b2) - outer(m1)) / m[:, None, None]
    if loss_type == "MSE_AFC":
        d, d1, d2 = m - np.abs(ref), m1, m2
    else:
        d = np.log(m) - np.log(np.abs(ref))
        d1 = m1 / m[:, None]
        d2 = m2 / m[:, None, None] - outer(m1) / m[:, None, None] ** 2
    return ((d ** 2).mean(), (2 * d[:, None] * d1).mean(0),
            (2 * (outer(d1) + d[:, None, None] * d2)).mean(0))


@pytest.fixture(scope="module")
def plates():
    """Per path: the JAX mixed-engine Problem, the port's Problem on its
    operator data, the truth, the JAX FRF at the truth and the JAX
    derivatives of the FRF at theta_0."""
    out = {}
    for path in PATHS:
        pj = pip.Problem(*_parts(pip, path), engine="mixed")
        truth = np.asarray(pj.parameters)
        ref = np.array(pj.getFRFunction()(FREQS, truth))
        od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
              if k != "trc"}
        pp = pt.Problem(*_parts(pt, path), device="cpu",
                        opdata=pt.opdata_from_jax(od, "cpu"))
        out[path] = (pj, pp, truth, ref, _jax_derivatives(pj, truth * START))
    return out


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("loss_type", LOSSES)
def test_hessian_matches_jax(plates, loss_type):
    for path in PATHS:
        pj, pp, truth, ref, derivs = plates[path]
        th0 = truth * START
        vj, gj, Hj = _loss_oracle(loss_type, derivs, ref)
        v, g, H = (a.numpy() for a in pp.getLossFunction(
            FREQS, ref, loss_type, th0).value_grad_hessian(np.ones(3)))
        assert abs(v - vj) <= 1e-8 * abs(vj), path
        assert _rel(g, gj) <= 1e-7, path
        assert _rel(H, Hj) <= 1e-6, path
        if loss_type == "MSE_LOG_AFC" and path == "accel":
            H_jax = np.asarray(pj.getLossFunction(
                FREQS, ref, loss_type, th0).hessian(np.ones(3)))
            assert _rel(H, H_jax) <= 1e-6


def test_hessian_consistent_and_symmetric(plates):
    """value_grad_hessian's value and gradient are the loss's own (the
    same primal sweep; the gradient by forward tangents instead of the
    backward, whose adjoint right-hand sides round differently: the
    FGMRES iterates follow them to ~1e-11), hessian() is its third output,
    and H is symmetric to the tangent solves' accuracy."""
    for path in PATHS:
        _, pp, truth, ref, _ = plates[path]
        loss = pp.getLossFunction(FREQS, ref, "MSE_LOG_AFC", truth * START)
        x = np.array([0.98, 1.01, 0.9])
        v, g, H = loss.value_grad_hessian(x)
        v2, g2 = loss.value_and_grad(x)
        assert float(v) == float(v2)
        assert _rel(g, g2) <= 1e-10
        torch.testing.assert_close(loss.hessian(x), H, rtol=0, atol=0)
        assert _rel(H, H.T) <= 1e-8


@pytest.mark.parametrize("optimizer", ["tr", "newton", "lbfgs"])
def test_solve_inverse_second_order(plates, optimizer, tmp_path,
                                    monkeypatch):
    monkeypatch.setenv("PIP_TPU_OUTPUT_DIR", str(tmp_path))
    _, pp, truth, ref, _ = plates["accel"]
    th0 = truth * START
    kw = {"tr": dict(N_steps=15, delta_max=0.5), "newton": dict(N_steps=4),
          "lbfgs": dict(N_steps=8)}[optimizer]
    # iterates on x = theta / theta_0 from x0 = 1
    res = pp.solveInverse(th0, "MSE_LOG_AFC", optimizer, ref_fr=(FREQS, ref),
                          use_scaling=True, case_name="so_", uid=optimizer,
                          **kw)
    xs = [np.asarray(x) for x in res.x_history]
    assert (tmp_path / f"so_{optimizer}.txt").exists()
    f = np.asarray(res.f_history)
    assert np.all(np.diff(f) <= 0) and f[-1] < 1e-2 * f[0]
    loss = pp.getLossFunction(FREQS, ref, "MSE_LOG_AFC", th0)
    _, g, H = (a.numpy() for a in loss.value_grad_hessian(np.ones(3)))
    if optimizer == "tr":
        # the first step: the JAX package's model solve on the port's
        # model at x0 (delta = delta_max / 10); the history records the
        # iterate after each step
        step = np.asarray(jax_tr_model(H, g, 0.05)[0])
        np.testing.assert_allclose(xs[0] - 1.0, step, rtol=0, atol=1e-10)
        err = (np.abs(res.x) - truth) / truth
        assert np.all(np.abs(err) <= 1e-6), err
        assert res.status == "Converged"
        return
    # Newton and L-BFGS record the iterate before each step
    np.testing.assert_array_equal(xs[0], np.ones(3))
    if optimizer == "newton":
        lam = 1e-8 * np.trace(H) / 3
        step = np.linalg.solve(H + lam * np.eye(3), -g)
        if step @ g > 0:
            step = -g
        d = xs[1] - xs[0]
        t = d @ step / (step @ step)
        assert t in [0.5 ** k for k in range(20)]
        np.testing.assert_allclose(d, t * step, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("optimizer", ["de", "shgo"])
def test_global_optimizers_match_jax(plates, optimizer, tmp_path,
                                     monkeypatch):
    """A 2-D bounds box scaled by its rows (use_scaling), the scipy result
    in optResult's fields; shgo with the material's constraints and the
    loss gradient and Hessian for its local minimizer."""
    monkeypatch.setenv("PIP_TPU_OUTPUT_DIR", str(tmp_path))
    pj, pp, truth, ref, _ = plates["accel"]
    bounds = np.stack([truth * 0.8, truth * 1.2], axis=1)
    kw = (dict(maxiter=2, popsize=4, tol=10.0, seed=0, polish=False)
          if optimizer == "de"
          else dict(options={"maxiter": 2, "f_tol": 1.0}))
    common = dict(ref_fr=(FREQS, ref), use_scaling=True,
                  use_constraints=optimizer == "shgo", report=False)
    rt = pp.solveInverse(bounds, "MSE_LOG_AFC", optimizer, uid="t", **common,
                         **{k: dict(v) if isinstance(v, dict) else v
                            for k, v in kw.items()})
    rj = pj.solveInverse(bounds, "MSE_LOG_AFC", optimizer, uid="j", **common,
                         **kw)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=1e-6)
    assert np.all((rt.x >= bounds[:, 0]) & (rt.x <= bounds[:, 1]))
    # the loss at points 1e-6 apart: its gradient there (~1e-2 per unit
    # relative change) times 1e-6 over the loss (~3e-4) bounds f's
    # relative difference by ~4e-5
    assert rt.f == pytest.approx(float(rj.f), rel=1e-4, abs=1e-18)
    assert rt.niter == rj.niter and rt.f_history == [-1.0]
    assert len(rt.x_history) == len(rj.x_history)
    log = np.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(log["x"][-1], rt.x)


def test_mode_picture_matches_jax(plates):
    import matplotlib.pyplot as plt

    for path in PATHS:
        pj, pp, truth, _, _ = plates[path]
        fig, ax = plt.subplots()
        vt = pp.getModePicture(150.0, ax=ax)
        plt.close(fig)
        fig, ax = plt.subplots()
        vj = np.asarray(pj.getModePicture(150.0, ax=ax))
        plt.close(fig)
        assert vt.shape == (pp.mesh.num_nodes,)
        np.testing.assert_allclose(vt, vj, rtol=1e-9, atol=1e-12 * vj.max())
        np.testing.assert_array_equal(pp.mode_field(150.0), vt)


def test_port_imports_no_jax_optax_matplotlib():
    """Importing the port, running L-BFGS and the mode field's host solve
    leaves jax, optax and matplotlib out of ``sys.modules``."""
    code = (
        "import sys, numpy as np, torch\n"
        "import plate_inverse_problem_tpu_torch as pt\n"
        "f = lambda x: ((x - torch.arange(3.0, dtype=x.dtype)) ** 2).sum()\n"
        "res = pt.optimize_lbfgs(f, np.zeros(3), N_steps=20)\n"
        "assert res.status == 'Converged', res.status\n"
        "acc = pt.Accelerometer('AP1030')\n"
        "g = pt.Geometry('symm', acc, pt.GeometryParams(100e-3, 20e-3, "
        "2e-3, 10e-3, None), ny=1)\n"
        "m = pt.get_material(7920.0, 'isotropic', E=200e9, G=75e9, "
        "beta=0.003)\n"
        "v = pt.Problem(g, m, acc, device='cpu').mode_field(150.0)\n"
        "assert np.all(np.isfinite(v))\n"
        "bad = [m for m in ('jax', 'optax', 'matplotlib') if m in "
        "sys.modules]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True)
