"""The first-order optimizers (port ``optimize/local.py``), FRF compression
(port ``io/compress.py``) and ``Problem.solveInverse`` with them, held
against the JAX package on the CPU.

The optimizers run host loops in the port and compiled scans in the JAX
package; on the same analytic objectives (a Rosenbrock valley and a
quadratic, the same formula in torch and in jax.numpy) from numpy-seeded
starts every history (x, f, gradient) agrees to 1e-12 and ``niter`` and
``status`` are equal, a run that converges early included.  The
``Compressor`` copy gives JAX's output bit for bit on a port FRF.  Through
``solveInverse`` on the ``symm`` ny = 1 plate (n = 420) each gradient-
descent step is x - h g with g from the port's ``LossFunction.grad`` (held
against JAX in tests/test_torch_inverse.py), to 1e-12, on the compressed
reference; a coordinate-descent visit moves one coordinate by its step
register (h or h / 5^k) times that coordinate's gradient.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu.optimize.local as jlocal
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.io.compress import Compressor as JCompressor
from plate_inverse_problem_tpu_torch.io.compress import Compressor
from plate_inverse_problem_tpu_torch.optimize import local as tlocal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUAD_MIN = np.array([0.7, -1.3, 0.4])
QUAD_W = np.array([1.0, 3.0, 0.5])


def rosen(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def quad(mod):
    c = mod.asarray(QUAD_MIN) if mod is jnp else torch.as_tensor(QUAD_MIN)
    w = mod.asarray(QUAD_W) if mod is jnp else torch.as_tensor(QUAD_W)

    def f(x):
        return (w * (x - c) ** 2).sum()
    return f


# (optimizer, objective, start dimension, kwargs); the "early" cases stop
# at f <= f_min well before N_steps
CASES = {
    "gd-rosen": ("optimize_gd", "rosen", 2, dict(N_steps=60, h=1e-3)),
    "gd-quad-early": ("optimize_gd", "quad", 3,
                      dict(N_steps=200, h=0.1, f_min=1e-6)),
    "cd-rosen": ("optimize_cd", "rosen", 2, dict(N_steps=30, h=1e-3)),
    "cd_mem-quad": ("optimize_cd_mem", "quad", 3, dict(N_steps=20, h=0.2)),
    "cd_mem2-rosen": ("optimize_cd_mem2", "rosen", 2,
                      dict(N_steps=30, h=4e-3)),
    "cd_mem2-quad-early": ("optimize_cd_mem2", "quad", 3,
                           dict(N_steps=100, h=0.45, f_min=1e-8)),
}


def _assert_same(rt, rj):
    """Histories to 1e-12 of their scale, the same niter and status."""
    assert rt.niter == rj.niter and rt.status == rj.status
    for name in ("f_history", "x_history", "grad_history"):
        a, b = (np.asarray(getattr(r, name)) for r in (rt, rj))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0), name
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(rt.f, rj.f, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_histories_match_jax(case):
    opt, obj, dim, kw = CASES[case]
    x0 = np.random.default_rng(len(case)).uniform(-1.0, 1.0, dim)
    fj = rosen if obj == "rosen" else quad(jnp)
    ft = rosen if obj == "rosen" else quad(torch)
    rj = getattr(jlocal, opt)(fj, jnp.asarray(x0), **kw)
    rt = getattr(tlocal, opt)(ft, x0, **kw)
    _assert_same(rt, rj)
    if case.endswith("early"):
        assert rt.status == "Converged"
        assert len(rt.f_history) < kw["N_steps"] * (1 if "gd" in opt else dim)


def test_fixed_parameter_function_matches_jax():
    """A pinned coordinate: the wrapped objective's value and the gradient
    descent on the free coordinates."""
    fj = jlocal.FixedParameterFunction(quad(jnp), 3, 1, QUAD_MIN[1])
    ft = tlocal.FixedParameterFunction(quad(torch), 3, 1, QUAD_MIN[1])
    y = np.array([0.1, -0.2])
    assert float(ft(torch.as_tensor(y))) == pytest.approx(
        float(fj(jnp.asarray(y))), rel=1e-15)
    _assert_same(tlocal.optimize_gd(ft, y, N_steps=40, h=0.1),
                 jlocal.optimize_gd(fj, jnp.asarray(y), N_steps=40, h=0.1))


@pytest.fixture(scope="module")
def plate():
    """The port's ``symm`` ny = 1 plate (n = 420, isotropic steel) and its
    FRF at the truth over 600 points."""
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                       ny=1)
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    p = pt.Problem(geom, mat, acc, device="cpu")
    freqs = np.linspace(40.0, 600.0, 600)
    return p, freqs, p.solveForward(freqs).numpy()


@pytest.mark.parametrize("alg", [0, 1])
def test_compressor_matches_jax(plate, alg):
    _, freqs, fr = plate
    for k in (50, 120):
        out_t = Compressor(freqs, fr, k, alg)(k)
        out_j = JCompressor(freqs, fr, k, alg)(k)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optimizer,use_scaling", [("gd", False),
                                                   ("cd_mem", True)])
def test_solve_inverse_first_order_steps(plate, optimizer, use_scaling):
    p, freqs, fr = plate
    h, k = (0.002, 60) if use_scaling else (1e-3, 80)
    res = p.solveInverse([0.1, 0.05, 0.2], "MSE_LOG_AFC", optimizer,
                         ref_fr=(freqs, fr), compression=(True, k),
                         use_rel=True, use_scaling=use_scaling, N_steps=2,
                         h=h, f_min=1e-12, report=False, log=False)
    start = np.asarray(p.parameters) * np.array([1.1, 1.05, 1.2])
    fc, frc = Compressor(freqs, fr, k, 1)(k)
    loss = p.getLossFunction(fc, frc, "MSE_LOG_AFC",
                             start if use_scaling else None)
    # the result is in physical units, the history in the iterated ones
    x_fin = np.asarray(res.x) / (start if use_scaling else 1.0)
    xs = [np.asarray(x) for x in res.x_history] + [x_fin]
    # with use_rel and use_scaling the iterate starts at the factors 1 +
    # arg0 and the loss scales it by theta_0 (the JAX package's rule)
    np.testing.assert_allclose(xs[0], [1.1, 1.05, 1.2] if use_scaling
                               else start, rtol=1e-15)
    n = xs[0].size
    steps = np.full(n, h)
    for t, (x, x_next) in enumerate(zip(xs[:-1], xs[1:])):
        g = loss.grad(x).numpy()
        assert res.f_history[t] == pytest.approx(float(loss(x)), rel=1e-12)
        if optimizer == "gd":
            np.testing.assert_allclose(x_next, x - h * g, rtol=1e-12)
            continue
        i = t % n
        moved = np.flatnonzero(x_next != x)
        assert set(moved) <= {i}
        if float(loss(x - steps[i] * (np.eye(n)[i] * g[i]))) > float(loss(x)):
            steps[i] /= 5.0
        np.testing.assert_allclose(x_next[i], x[i] - steps[i] * g[i],
                                   rtol=1e-12)
    assert len(res.f_history) == (2 if optimizer == "gd" else 2 * n)
