"""The port's forward-mode Jacobian (plate_inverse_problem_tpu_torch
``ResidualFunction(jac_mode="fwd")``, ``kind="complex"``, ``freq_chunk``,
Gauss-Newton and ``JointResidual`` on plain callables) held against the
JAX package's forward mode on the CPU.

The plate is the JAX suite's ``symm`` ny = 1 strip (isotropic steel), on
both paths: the 3-field path with the AP1030 accelerometer (n = 420) and
the pure-bending path without it (n = 270), 9 frequencies over 40-300 Hz
(through the ~150 Hz resonance), theta_0 = truth x (1.05, 1.02, 1.2).
The port runs on the JAX mixed engine's operator data
(``opdata_from_jax``: one band basis, one pattern).  The module compiles
one JAX Jacobian per path, the forward-mode 'complex' r + J at theta_0:
the log_afc and afc residuals and their Jacobians follow from it in
numpy (fr = re + i im, d|fr| = Re(conj(fr) dfr) / |fr|).  Tolerances:

* forward mode against the port's adjoint mode: r to 1e-12 relative, J to
  1e-6 relative and 1e-8 of its max |entry| (tests/test_problem.py's
  bounds for the same comparison in the JAX package);
* port against JAX: r and J to 1e-7 of their max |entry| (the two sweeps
  run the same f32 preconditioner in different summation orders; the
  deviations measured here are 2.4e-9 and 5.9e-10);
* ``freq_chunk``: the chunked r to the unchunked one to 1e-10 (each
  block's primal is a sweep of its own), J as the forward mode to the
  adjoint mode, and to JAX as above;
* Gauss-Newton and ``JointResidual`` on analytic callables: the JAX
  package's iterates to 1e-12.
"""
import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.optimize import (
    JointResidual as JaxJointResidual,
    optimize_gauss_newton as jax_gauss_newton)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREQS = np.linspace(40.0, 300.0, 9)
START = np.array([1.05, 1.02, 1.2])
PATHS = ("accel", "symm")
KINDS = ("log_afc", "afc", "complex")


def _parts(mod, path):
    acc = mod.Accelerometer("AP1030")
    geom = mod.Geometry("symm", acc,
                        mod.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                        ny=1)
    mat = mod.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    return geom, mat, acc if path == "accel" else None


def _from_complex(r, J, ref):
    """The JAX complex r + J at theta_0 -> r and J of every kind."""
    F = ref.size
    fr = (r[:F] + ref.real) + 1j * (r[F:] + ref.imag)
    dfr = J[:F] + 1j * J[F:]
    mag = np.abs(fr)
    dmag = (np.conj(fr)[:, None] * dfr).real / mag[:, None]
    return {"complex": (r, J),
            "afc": (mag - np.abs(ref), dmag),
            "log_afc": (np.log(mag) - np.log(np.abs(ref)),
                        dmag / mag[:, None])}


@pytest.fixture(scope="module")
def plates():
    """Per path: the port's Problem on the JAX mixed engine's data, the
    truth, the reference FRF at the truth (complex on both paths) and the
    JAX forward-mode r + J of every kind at theta_0."""
    out = {}
    for path in PATHS:
        pj = pip.Problem(*_parts(pip, path), engine="mixed")
        truth = np.asarray(pj.parameters)
        ref = np.array(pj.getFRFunction()(FREQS, truth)).astype(complex)
        rf = pj.getResidualFunction(FREQS, ref, kind="complex")
        assert rf.jac_mode == "fwd"
        r, J = (np.asarray(a) for a in rf.value_and_jac(truth * START))
        od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
              if k != "trc"}
        pp = pt.Problem(*_parts(pt, path), device="cpu",
                        opdata=pt.opdata_from_jax(od, "cpu"))
        out[path] = (pp, truth, ref, _from_complex(r, J, ref))
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("kind", ["log_afc", "afc"])
def test_fwd_matches_adjoint(plates, kind):
    for path in PATHS:
        pp, truth, ref, _ = plates[path]
        th0 = truth * START
        rf_a = pp.getResidualFunction(FREQS, ref, kind=kind,
                                      jac_mode="adjoint")
        rf_f = pp.getResidualFunction(FREQS, ref, kind=kind, jac_mode="fwd")
        assert rf_a.jac_mode == "adjoint" and rf_f.jac_mode == "fwd"
        ra, Ja = (a.numpy() for a in rf_a.value_and_jac(th0))
        rf, Jf = (a.numpy() for a in rf_f.value_and_jac(th0))
        np.testing.assert_allclose(ra, rf, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(Ja, Jf, rtol=1e-6,
                                   atol=1e-8 * np.abs(Jf).max())
        np.testing.assert_array_equal(rf, rf_f(th0).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_fwd_matches_jax(plates, kind):
    for path in PATHS:
        pp, truth, ref, jax_rj = plates[path]
        rf = pp.getResidualFunction(FREQS, ref, kind=kind, jac_mode="fwd")
        r, J = (a.numpy() for a in rf.value_and_jac(truth * START))
        rj, Jj = jax_rj[kind]
        assert r.shape == rj.shape and J.shape == Jj.shape
        assert _rel(r, rj) <= 1e-7, path
        assert _rel(J, Jj) <= 1e-7, path


def test_freq_chunk(plates):
    """freq_chunk = 4 runs three blocks over the 9 frequencies, the last
    padded by repeating the last frequency."""
    for path in PATHS:
        pp, truth, ref, jax_rj = plates[path]
        th0 = truth * START
        r, J = (a.numpy() for a in pp.getResidualFunction(
            FREQS, ref, jac_mode="fwd").value_and_jac(th0))
        rf_c = pp.getResidualFunction(FREQS, ref, jac_mode="fwd",
                                      freq_chunk=4)
        assert rf_c._chunk == 4
        rc, Jc = (a.numpy() for a in rf_c.value_and_jac(th0))
        assert rc.shape == r.shape and Jc.shape == J.shape
        # each block's primal is a sweep of its own lanes, rounded in
        # another batch shape (measured 8.6e-12)
        np.testing.assert_allclose(rc, r, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(Jc, J, rtol=1e-6,
                                   atol=1e-8 * np.abs(J).max())
        assert _rel(Jc, jax_rj["log_afc"][1]) <= 1e-7, path


def test_mode_selection_and_chunk_policy(plates):
    """'auto' resolves as in the JAX package; freq_chunk raises with
    'complex' and warns (and is dropped) under 'adjoint'; the factory
    takes _auto_freq_chunk(lanes=1 + p) for the forward mode of a scalar
    kind only."""
    pp, _, ref, _ = plates["accel"]
    assert pp.getResidualFunction(FREQS, ref).jac_mode == "adjoint"
    assert pp.getResidualFunction(FREQS, ref,
                                  kind="complex").jac_mode == "fwd"
    with pytest.raises(ValueError, match="freq_chunk"):
        pp.getResidualFunction(FREQS, ref, kind="complex", freq_chunk=4)
    with pytest.raises(ValueError, match="adjoint"):
        pp.getResidualFunction(FREQS, ref, kind="complex",
                               jac_mode="adjoint")
    with pytest.warns(RuntimeWarning, match="freq_chunk"):
        rf = pp.getResidualFunction(FREQS, ref, freq_chunk=4)
    assert rf.jac_mode == "adjoint" and rf._chunk is None
    seen = []

    def policy(lanes=1):
        seen.append(lanes)
        return 5

    pp._auto_freq_chunk = policy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert pp.getResidualFunction(FREQS, ref,
                                          jac_mode="fwd")._chunk == 5
            assert pp.getResidualFunction(FREQS, ref)._chunk is None
            assert pp.getResidualFunction(FREQS, ref,
                                          kind="complex")._chunk is None
    finally:
        del pp._auto_freq_chunk
    assert seen == [4]


def test_auto_freq_chunk_matches_jax():
    """A sweep's chunk, and None below 300k pattern entries, are the JAX
    package's.  The forward mode's sweeps run in the sweep's chunks, so its
    own chunk bounds only what it holds across them (_FWD_HELD_VECS f64
    n-vectors a lane, to _fwd_budget: 2 GB on the CPU): the largest
    multiple of the sweep's chunk that fits, one at least."""
    for nnz, n_free, lanes, fwd in ((200_000, 21000, 4, None),
                                    (2_000_000, 20916, 1, None),
                                    (2_000_000, 20916, 4, 128),
                                    (2_000_000, 20916, 9, 64),
                                    (9_000_000, 104000, 9, 32),
                                    (9_000_000, 104000, 1, None)):
        fake = SimpleNamespace(freq_chunk=None, n_refine=16, n_free=n_free,
                               device=torch.device("cpu"),
                               op=SimpleNamespace(
                                   pattern=SimpleNamespace(nnz=nnz)))
        chunk = pt.Problem._auto_freq_chunk(fake, lanes)
        if fwd is None:
            assert chunk == pip.Problem._auto_freq_chunk(fake, lanes)
            continue
        sweep = pip.Problem._auto_freq_chunk(fake, 1)
        held = 16.0 * n_free * 8.0 * lanes
        assert chunk == fwd and chunk % sweep == 0
        assert chunk == sweep or chunk * held <= 2.0e9
        assert (chunk + sweep) * held > 2.0e9
    fake.freq_chunk = 24
    assert pt.Problem._auto_freq_chunk(fake, 9) == 24


def _analytic_residuals(mod):
    """A residual with a curved valley and the JAX suite's two flat-
    direction datasets, in torch or jax.numpy."""
    arr = jnp.asarray if mod is jnp else (
        lambda v: torch.stack([torch.as_tensor(e, dtype=torch.float64)
                               for e in v]))
    target = (2.0, -1.0)

    def curved(x):
        return arr([x[0] - target[0], 10.0 * (x[1] - x[0] ** 2 + 3.0),
                    0.1 * (x[0] - target[0]) * (x[1] - target[1])])

    def res_a(x):
        return arr([x[0] - target[0], 0.5 * (x[0] - target[0])])

    def res_b(x):
        return arr([x[1] - target[1]])

    return curved, res_a, res_b


def test_gauss_newton_plain_callables_match_jax():
    """Gauss-Newton on a plain callable (J by torch.func.jacfwd) and on a
    JointResidual of plain callables: the JAX package's iterates."""
    tc, ta, tb = _analytic_residuals(torch)
    jc, ja, jb = _analytic_residuals(jnp)
    x0 = np.random.default_rng(8).uniform(-1.0, 1.0, 2)
    for rt_, rj_ in ((tc, jc),
                     (pt.JointResidual([ta, tb], weights=[1.0, 2.0]),
                      JaxJointResidual([ja, jb], weights=[1.0, 2.0]))):
        rt = pt.optimize_gauss_newton(rt_, x0, N_steps=12)
        rj = jax_gauss_newton(rj_, jnp.asarray(x0), N_steps=12)
        assert rt.niter == rj.niter and rt.status == rj.status
        for name in ("f_history", "x_history", "grad_history"):
            a, b = (np.asarray(getattr(r, name)) for r in (rt, rj))
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("path", PATHS)
def test_plain_callable_through_the_sweep(plates, path):
    """A plain callable that runs the port's sweep (a residual object's
    ``__call__``): its jacfwd goes through the implicit sweep's forward
    rule, inside JointResidual as in Gauss-Newton."""
    pp, truth, ref, jax_rj = plates[path]
    th0 = truth * START
    rf = pp.getResidualFunction(FREQS, ref, kind="complex",
                                scaling_params=th0)
    joint = pt.JointResidual([lambda x: rf(x)])
    r, J = joint.value_and_jac(np.ones(3))
    rj, Jj = jax_rj["complex"]
    assert _rel(r, rj) <= 1e-7
    assert _rel(J, Jj * th0[None, :]) <= 1e-7
    np.testing.assert_array_equal(joint(np.ones(3)), r)


def test_solve_inverse_gn_mse_step(plates):
    """solveInverse('gn') with MSE runs the 'complex' residual: its first
    step is a Levenberg-Marquardt step of the JAX r + J at theta_0, at one
    of the damping values 1e-3 x 4^k the backtracking tries."""
    for path in PATHS:
        pp, truth, ref, jax_rj = plates[path]
        th0 = truth * START
        res = pp.solveInverse(th0, "MSE", "gn", ref_fr=(FREQS, ref),
                              use_scaling=True, N_steps=2, report=False,
                              log=False)
        r, J = jax_rj["complex"]
        J = J * th0[None, :]
        m = r.size
        JtJ = J.T @ J / m
        steps = [np.linalg.solve(
            JtJ + 1e-3 * 4.0 ** k * np.diag(np.diag(JtJ)), -(J.T @ r) / m)
            for k in range(15)]
        assert res.f_history[0] == pytest.approx(r @ r / m, rel=1e-7)
        d = res.x_history[1] - 1.0
        assert min(_rel(d, s) for s in steps) <= 1e-6, path
        assert res.f_history[1] < res.f_history[0]
