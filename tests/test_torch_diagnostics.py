"""The port's diagnostics (plate_inverse_problem_tpu_torch/diagnostics)
held against the JAX package's on the CPU, on the ``symm`` ny = 1 plate
(isotropic steel; n = 420 on the 3-field path).

* ``frf_oracle`` (the plain f64 splu of the port's own host operator)
  gives the JAX function's bits on both paths when it is handed the JAX
  package's complex moduli, and agrees to 1e-9 on its own (one modulus
  differs in its last bit);
* ``oracle_check`` picks the JAX function's points and stays under 1e-6
  on both paths (JAX tests/test_aux.py:77);
* ``polish_peaks`` meets every assertion of JAX
  tests/test_diagnostics.py:6 against the longdouble-refined
  ``oracle.splu_frf`` (after < 1e-8 and < 0.1 x before, off-peak values
  unchanged, ``solveForward(polish_peaks=True)`` the same values, the
  starved ``n_refine=1`` case returned verbatim, the modal engine's
  oracle fallback), on the band layout too, and its polished peak matches
  the JAX function's to 1e-8 relative (both land within ~1e-11 of splu);
* ``parity``: the expansion's eigenvalues against the JAX function's
  (ARPACK) to 1e-10 relative, ``frf_from_expansion`` to 1e-9, the
  ``checksum_interval`` bracket to 1e-9 (the same seeded samples);
  ``ritz`` is a copy and gives the same bits;
* ``checks``, ``profile`` and ``smoke`` (port only: torch guards, a
  torch.profiler Chrome trace, the device report).
"""
import json
import os

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.diagnostics import oracle as joracle
from plate_inverse_problem_tpu.diagnostics import parity as jparity
from plate_inverse_problem_tpu.diagnostics import ritz as jritz
from plate_inverse_problem_tpu_torch.diagnostics import (
    checks, oracle, parity, profile, ritz, smoke)
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, 10e-3, None)
MAT = dict(E=200e9, G=75e9, beta=0.003)
FREQS = np.linspace(60.0, 400.0, 17)
SCALE = np.array([1.1, 0.9, 1.2])        # theta / truth of the polish


def _parts(pkg):
    acc = pkg.Accelerometer("AP1030")
    mat = pkg.get_material(7920.0, "isotropic", **MAT)
    geom = pkg.Geometry("symm", acc, pkg.GeometryParams(*GP), ny=1)
    return geom, mat, acc


def _port(accel=True, **kw):
    geom, mat, acc = _parts(pt)
    return pt.Problem(geom, mat, acc if accel else None, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_3field():
    """The JAX test's mixed-engine Problem (tests/test_diagnostics.py)."""
    geom, mat, acc = _parts(pip)
    return pip.Problem(geom, mat, acc, engine="mixed")


@pytest.fixture(scope="module")
def jax_bending():
    """The JAX package's pure-bending Problem at its CPU default engine
    (tests/test_aux.py:77)."""
    geom, mat, _ = _parts(pip)
    return pip.Problem(geom, mat, None)


@pytest.fixture(scope="module")
def port_3field():
    return _port()


def test_frf_oracle_matches_jax(jax_3field, jax_bending, port_3field,
                                monkeypatch):
    """The plain splu FRF on both paths, at the truth and off it, at the
    peak and off it: on the JAX package's complex moduli the same bits
    (the same complex128 operator, every slot of the pattern kept, and the
    same splu); on the port's own moduli to 1e-9, because one of them
    differs in its last bit (Im A66 of the isotropic plate, 5.8e-11 of
    4.5e8: the port forms beta * Re, the JAX transform a complex product)
    and the unscaled system's conditioning carries that to 6e-11 of the
    FRF."""
    import plate_inverse_problem_tpu_torch.oracle as host_oracle

    th = np.asarray(port_3field.parameters) * SCALE
    f = FREQS[[0, 5, 9, 16]]
    cases = ((jax_3field, port_3field, th), (jax_bending, _port(accel=False),
                                             None))
    for jp_, p_, params in cases:
        ref = joracle.frf_oracle(jp_, f, params)
        got = oracle.frf_oracle(p_, f, params)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0.0)

    def jax_moduli(p_, theta, omega=0.0):
        h = p_.geometry.height
        if p_.is_symmetric_path:
            return np.asarray(p_._jax_mat.get_D_transform(h)(theta, omega))
        return tuple(np.asarray(x) for x in
                     p_._jax_mat.get_ABD_transform(h)(theta, omega))

    monkeypatch.setattr(host_oracle, "_moduli", jax_moduli)
    for jp_, p_, params in cases:
        p_._jax_mat = jp_.material
        np.testing.assert_array_equal(oracle.frf_oracle(p_, f, params),
                                      joracle.frf_oracle(jp_, f, params))


def test_oracle_check_matches_jax_on_both_paths(jax_3field, jax_bending,
                                                port_3field):
    """The audit of the JAX test: the same checked points (the |FRF| peak
    and points spread over the band) and under 1e-6, on the mixed engine
    (3-field, over FREQS: the JAX sweep's compile serves the polish test
    too) and at the CPU default engine (pure bending: modal, the JAX
    test's 9 points)."""
    for jp_, p_, freqs, n_points in (
            (jax_3field, port_3field, FREQS, 4),
            (jax_bending, _port(accel=False, engine=None),
             np.linspace(60.0, 400.0, 9), 3)):
        ref = joracle.oracle_check(jp_, freqs, n_points=n_points)
        rep = oracle.oracle_check(p_, freqs, n_points=n_points)
        assert rep["worst_rel_err"] < 1e-6, rep
        assert rep["at_hz"] in rep["checked_hz"]
        assert rep["checked_hz"] == ref["checked_hz"]
        assert rep["engine"] == ref["engine"]


def test_polish_peaks_meets_the_jax_tests_assertions(port_3field):
    """Every assertion of JAX tests/test_diagnostics.py:6, against the
    refined splu: a perturbed-theta peak polished below 1e-8 and by 10x,
    the other values untouched, ``solveForward(polish_peaks=True)`` the
    same operation, a starved Krylov budget's peak returned verbatim, and
    the modal engine's oracle fallback."""
    p = port_3field
    th = np.asarray(p.parameters) * SCALE
    fr = p.solveForward(FREQS, th).numpy()
    i = int(np.argmax(np.abs(fr)))
    ref = splu_frf(p, FREQS[i:i + 1], th)[0]
    e_before = abs(fr[i] - ref) / abs(ref)
    fr_pol, info = oracle.polish_peaks(p, FREQS, fr=fr, params=th, passes=1)
    e_after = abs(fr_pol[i] - ref) / abs(ref)
    assert info["mode"] == "residual" and i in info["indices"]
    assert e_after < 1e-8, (e_before, e_after)
    assert e_after < 0.1 * e_before, (e_before, e_after)
    mask = np.ones(FREQS.size, bool)
    mask[info["indices"]] = False
    assert np.array_equal(fr_pol[mask], fr[mask])
    fr_sf = p.solveForward(FREQS, th, polish_peaks=True)
    assert isinstance(fr_sf, torch.Tensor)
    np.testing.assert_allclose(fr_sf.numpy(), fr_pol, rtol=1e-12, atol=0.0)

    p_bad = _port(n_refine=1, refine_tol=1e-14)
    th_bad = np.asarray(p_bad.parameters) * np.array([1.35, 0.72, 1.6])
    fr_bad = p_bad.solveForward(FREQS, th_bad).numpy()
    fr_bp, info_bad = oracle.polish_peaks(p_bad, FREQS, fr=fr_bad,
                                          params=th_bad, passes=2)
    assert info_bad["improved"] == [False]
    np.testing.assert_array_equal(fr_bp, fr_bad)

    p_modal = _port(engine="modal")
    fr_m = p_modal.solveForward(FREQS).numpy()
    fr_mp, info_m = oracle.polish_peaks(p_modal, FREQS, fr=fr_m)
    assert info_m["mode"] == "oracle"
    im = info_m["indices"][0]
    assert fr_mp[im] == oracle.frf_oracle(p_modal, FREQS[im])[0]
    assert abs(fr_mp[im] - splu_frf(p_modal, FREQS[im:im + 1])[0]) <= (
        1e-10 * abs(fr_mp[im]))


def test_polish_peaks_matches_jax(jax_3field, port_3field):
    """The polished peak of the JAX function and of the port, each from
    its own sweep at the perturbed theta, to 1e-8 relative."""
    th = np.asarray(port_3field.parameters) * SCALE
    fr_j = np.asarray(jax_3field.solveForward(FREQS, th))
    pol_j, info_j = joracle.polish_peaks(jax_3field, FREQS, fr=fr_j,
                                         params=th)
    pol, info = oracle.polish_peaks(port_3field, FREQS, params=th)
    assert info["indices"] == info_j["indices"] and info["mode"] == "residual"
    i = info["indices"]
    np.testing.assert_allclose(pol[i], pol_j[i], rtol=1e-8, atol=0.0)


def test_polish_peaks_on_the_band_layout():
    """The band layout (``operator_layout="band"``: RCM-permuted device
    vectors) maps the host residual in and the correction out: the peak
    and an explicit second index polished below 1e-8 of the refined
    splu."""
    p = _port(operator_layout="band")
    p.getFRCore()
    assert p._band_layout is not None
    th = np.asarray(p.parameters) * SCALE
    fr = p.solveForward(FREQS, th).numpy()
    peaks = [3, int(np.argmax(np.abs(fr)))]
    fr_pol, info = oracle.polish_peaks(p, FREQS, fr=fr, params=th,
                                       peaks=peaks)
    assert info["mode"] == "residual" and info["indices"] == sorted(peaks)
    i, freqs = info["indices"], FREQS
    ref = splu_frf(p, freqs[i], th)
    assert np.all(np.abs(fr_pol[i] - ref) <= 1e-8 * np.abs(ref))


def test_parity_expansion_matches_jax(jax_3field, port_3field):
    """The mode-acceleration expansion: eigenvalues (the port's dense
    generalized eigh of the equilibrated pencil against ARPACK's
    shift-invert) to 1e-10, every per-mode and static scalar to 1e-9 of
    its largest magnitude, the FRF from it to 1e-9; ``resonances_hz`` and
    ``richardson`` are the same numpy.  The port's eigenvalues are
    Rayleigh quotients of the dense eigh's vectors (2e-12 from ARPACK's
    here; the eigh's own carry eps times the largest eigenvalue, 2.7e-10
    of the lowest)."""
    ej = jparity.modal_frf_expansion(jax_3field, 600.0, n_modes_min=12)
    ep = parity.modal_frf_expansion(port_3field, 600.0, n_modes_min=12)
    assert ep["lam"].shape == ej["lam"].shape
    np.testing.assert_allclose(ep["lam"], ej["lam"], rtol=1e-10, atol=0.0)
    assert ep["beta"] == pytest.approx(ej["beta"], rel=1e-14, abs=0.0)
    for k in ("stat_b", "stat_m", "r0"):
        np.testing.assert_allclose(ep[k], ej[k], rtol=0.0,
                                   atol=1e-9 * np.abs(ej[k]).max())
    freqs = np.linspace(40.0, 600.0, 50)
    fr = parity.frf_from_expansion(ep, freqs)
    np.testing.assert_allclose(fr, jparity.frf_from_expansion(ej, freqs),
                               rtol=1e-9, atol=0.0)
    # against the sweep itself, with the JAX test's 48 modes at least
    ep48 = parity.modal_frf_expansion(port_3field, 600.0, n_modes_min=48)
    sweep = port_3field.solveForward(freqs).numpy()
    np.testing.assert_allclose(parity.frf_from_expansion(ep48, freqs),
                               sweep, rtol=5e-6)
    np.testing.assert_array_equal(parity.resonances_hz(ep, 600.0),
                                  jparity.resonances_hz(ep, 600.0))
    fs = [np.array([150.0, 900.0]), np.array([152.0, 905.0]),
          np.array([152.5, 906.0])]
    for a, b in zip(parity.richardson(*fs), jparity.richardson(*fs)):
        np.testing.assert_array_equal(a, b)


def test_checksum_interval_matches_jax(jax_3field, port_3field):
    """The checksum bracket of tests/test_golden_parity.py's call, on the
    ny = 1 plate: the port's and the JAX function's bracket to 1e-9 (the
    same seeded eigenvalue samples), each holding its own checksum."""
    freqs = np.linspace(40.0, 600.0, 50)
    ej = jparity.modal_frf_expansion(jax_3field, 600.0, n_modes_min=12)
    ep = parity.modal_frf_expansion(port_3field, 600.0, n_modes_min=12)
    lo, hi = parity.checksum_interval(ep, freqs, [0.01], slack=1.0,
                                      n_samples=200)
    lo_j, hi_j = jparity.checksum_interval(ej, freqs, [0.01], slack=1.0,
                                           n_samples=200)
    np.testing.assert_allclose([lo, hi], [lo_j, hi_j], rtol=1e-9, atol=0.0)
    ours = float(parity.frf_from_expansion(ep, freqs).sum())
    assert lo <= ours <= hi and lo < hi


def test_ritz_copy_equals_jax():
    """``clamped_strip_frequencies`` (host numpy, a copy): the same bits."""
    acc = pt.Accelerometer("AP1030")
    args = (100e-3, 20e-3, 2e-3, 200e9, 200e9 / (2 * 75e9) - 1, 7920.0)
    kw = dict(accel_pos=(10e-3, 0.0), n_x=8, n_y=4, n_modes=3)
    np.testing.assert_array_equal(
        ritz.clamped_strip_frequencies(*args, accel=acc, **kw),
        jritz.clamped_strip_frequencies(
            *args, accel=pip.Accelerometer("AP1030"), **kw))


def test_guards_raise_on_non_finite():
    """``assert_finite``, ``checked`` (err, out with ``err.throw()``) and
    ``nan_guard`` on tensors and arrays (JAX tests/test_aux.py's cases)."""
    ok = checks.nan_guard(lambda x: x * 2)
    np.testing.assert_allclose(ok(torch.ones(3)).numpy(), 2.0)
    bad = checks.nan_guard(lambda x: (x / 0.0, {"y": x}))
    with pytest.raises(FloatingPointError):
        bad(torch.ones(3))
    with pytest.raises(FloatingPointError), np.errstate(divide="ignore"):
        checks.nan_guard(lambda x: x / 0.0)(np.ones(2))
    g = checks.assert_finite("loss")

    def f(x):
        return torch.sum(g(torch.log(x)))

    err, out = checks.checked(f)(torch.tensor([1.0, 2.0]))
    err.throw()
    assert err.get() is None and float(out) == pytest.approx(np.log(2.0))
    err, out = checks.checked(f)(torch.tensor([-1.0, 2.0]))
    assert out is None and "loss" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()


def test_profile_call_and_device_report(tmp_path):
    """``profile_call`` writes a Chrome trace of the call (its torch ops
    named in it) into a run directory under ``logdir``; on the CPU
    ``device_report`` names the CPU with no power limit and
    ``test_function`` on the CPU gives numpy's 2x + sin(x) in the input's
    dtype, and on the card (its default) raises where there is none."""
    x = torch.ones(64, 64, dtype=torch.float64)
    out, run, dt = profile.profile_call(lambda a: (a @ a).sum(), x,
                                        label="unit", logdir=str(tmp_path))
    assert float(out) == 64.0 ** 3 and dt > 0.0
    assert os.path.dirname(run) == str(tmp_path)
    with open(os.path.join(run, profile.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    rep = smoke.device_report()
    assert rep == {"backend": "cpu", "n_devices": 0, "x64": True,
                   "devices": [{"name": "cpu", "power_limit": None}]}
    xs = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    y = smoke.test_function(xs, device="cpu")
    assert y.dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            smoke.test_function(xs)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            smoke.test_function(xs, device="cuda")
    np.testing.assert_allclose(y, 2.0 * xs + np.sin(xs), rtol=1e-6,
                               atol=1e-6)
