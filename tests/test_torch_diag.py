"""``Problem.diagnoseSweep``, the API gaps and the dense tier away from the
build point (port ``models/problem.py``, ``ops/mixed.py``), on the CPU.

* ``diagnoseSweep`` against the JAX package's on the same operator data
  (``opdata_from_jax``, one band basis) on the ``symm`` ny = 1 plate (n =
  420, isotropic steel, one JAX compile): the FRF to 1e-8 relative at the
  build point, and ``converged`` true wherever JAX's solve converged (the
  port gives a lane that has not converged when its budget is spent the
  budget again, its rescue cycles, so it may converge where JAX's stops).
  The port's diagnostics FRF is its ``solveForward`` FRF bit for bit (the
  same solve).
* Two fresh Problems give the same band basis, FRF and Newton iterates
  (the basis's fixed ARPACK start vector), bit for bit.
* The engines' options ``chunk`` and ``n_modes`` take effect; the API gap
  ``polish_peaks`` raises ``NotImplementedError`` naming its ROADMAP item;
  ``cpu=`` is accepted and ignored.
* ROADMAP Queue 3's dense-tier fault: the SOL 45 deg cut on ``sh_i``
  refine = 1 (n = 1466, "auto": flat + dense, f64 Krylov basis), built at
  the truth, swept at s and s0 x truth on two ARPACK bases from seeded
  start vectors; the 12 frequencies around the first resonance within
  1e-6 of the refined ``oracle.splu_frf`` and every lane converged.  The
  lanes are independent, so the 12 reproduce the full sweep's values.
  With the JAX package's f32 basis and no rescue cycles the two cases at
  s0 are 2.1e-6 and 2.7e-6 off; with the f64 basis they are 6.8e-8 off
  either way, and at s the rescue cycles converge the 7 lanes its budget
  leaves unconverged.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.ops import sweep
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP_SYMM = (100e-3, 20e-3, 2e-3, 10e-3, None)   # tests/test_problem.py
FREQS = np.linspace(40.0, 600.0, 24)
SOL_TRUE = np.array([120e9, 8.5e9, 4.5e9, 0.30, 0.006])
S = np.array([0.7, 1.3, 0.6, 1.15, 0.5])
S0 = np.array([1.35, 0.70, 1.40, 0.85, 1.50])
SWEEP = np.linspace(40.0, 600.0, 512)


def _steel(mod):
    acc = mod.Accelerometer("AP1030")
    geom = mod.Geometry("symm", acc, mod.GeometryParams(*GP_SYMM), ny=1)
    mat = mod.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    return geom, mat, acc


@pytest.fixture(scope="module")
def steel():
    pj = pip.Problem(*_steel(pip), engine="mixed")
    od = pj.getFRCore()[1]
    pp = pt.Problem(*_steel(pt), device="cpu",
                    opdata=pt.opdata_from_jax(od, "cpu"))
    return pj, pp


@pytest.mark.parametrize("point", [(1.0, 1.0, 1.0), (1.1, 0.9, 1.0)])
def test_diagnose_sweep_matches_jax(steel, point):
    """At the build point both solves are f64-grade and their FRFs agree
    to 1e-8.  At (1.1, 0.9, 1.0) x truth JAX's solve leaves a lane
    unconverged (its dense tier runs an f32 inverse, ROADMAP Queue 3), and
    its FRF is ~1e-6 off there; the port's solve (an f64 Krylov basis,
    and rescue cycles for a lane its budget leaves unconverged) converges
    it, and its FRF meets the refined splu."""
    pj, pp = steel
    th = np.asarray(pp.parameters) * np.asarray(point)
    dj = pj.diagnoseSweep(FREQS, th)
    dt = pp.diagnoseSweep(FREQS, th)
    assert set(dt) == set(dj)
    for k, v in dt.items():
        assert isinstance(v, np.ndarray) and v.shape == FREQS.shape, k
    assert np.all(dt["converged"][dj["converged"]])
    np.testing.assert_array_equal(dt["fr"],
                                  pp.solveForward(FREQS, th).numpy())
    # the norms are in the units of b (the port solves a scaled b)
    np.testing.assert_allclose(dt["initial_residual_norm"],
                               dj["initial_residual_norm"], rtol=1e-6)
    if point == (1.0, 1.0, 1.0):
        np.testing.assert_allclose(dt["fr"], dj["fr"], rtol=1e-8)
        return
    assert not np.all(dj["converged"]) and np.all(dt["converged"])
    ref = splu_frf(pp, FREQS, th)
    assert np.all(np.abs(dt["fr"] - ref) <= 1e-6 * np.abs(ref))


@pytest.mark.parametrize("call", ["chunk", "n_modes", "polish_peaks"])
def test_api_gaps_raise_not_implemented(call, monkeypatch):
    """The options of the engines the port once refused now take effect:
    ``chunk=8`` builds the direct sweep's 24 matrices 8 at a time (and
    factors each alone, one LU a frequency), and
    ``n_modes=12`` truncates the modal basis (another FRF than the full
    basis, whose n_modes = n gives the full basis's bits), and
    ``polish_peaks=True`` corrects the |FRF| peak by one exact host
    residual (to 1e-8 of the refined splu, no further off than the
    sweep's own value) and leaves the other points as the sweep gave
    them; ``cpu=`` is accepted and ignored."""
    parts = _steel(pt)
    if call == "chunk":
        sizes = {"dense": [], "lu": []}

        def counted(fn, key):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                sizes[key].append((out[0] if key == "lu" else out).shape[0])
                return out
            return wrapped

        monkeypatch.setattr(sweep, "dense_operator",
                            counted(sweep.dense_operator, "dense"))
        monkeypatch.setattr(torch.linalg, "lu_factor",
                            counted(torch.linalg.lu_factor, "lu"))
        p = pt.Problem(*parts, device="cpu", engine="direct", chunk=8)
        y = p.solveForward(FREQS).numpy()
        assert p.chunk == 8 and sizes == {"dense": [8, 8, 8],
                                          "lu": [1] * FREQS.size}
        ref = splu_frf(p, FREQS[[0, 11]])
        assert np.all(np.abs(y[[0, 11]] - ref) <= 1e-9 * ref)
    elif call == "n_modes":
        full = pt.Problem(*parts, device="cpu", engine="modal")
        y_full = full.solveForward(FREQS).numpy()
        p = pt.Problem(*parts, device="cpu", engine="modal", n_modes=12)
        y = p.solveForward(FREQS).numpy()
        assert np.all(np.isfinite(y))
        assert np.max(np.abs(y - y_full) / y_full) > 1e-4
        q = pt.Problem(*parts, device="cpu", engine="modal",
                       n_modes=full.n_free)
        assert np.array_equal(q.solveForward(FREQS).numpy(), y_full)
    else:
        p = pt.Problem(*parts, device="cpu", cpu=4)   # accepted, unused
        y = p.solveForward(FREQS).numpy()
        y_pol = p.solveForward(FREQS, polish_peaks=True).numpy()
        i = int(np.argmax(y))
        ref = splu_frf(p, FREQS[i:i + 1])[0]
        assert abs(y_pol[i] - ref) <= min(1e-8 * ref, abs(y[i] - ref))
        others = np.arange(FREQS.size) != i
        np.testing.assert_array_equal(y_pol[others], y[others])


def test_band_basis_and_newton_path_reproducible():
    """Two fresh Problems on the same plate build the same band basis
    (ARPACK from ``band_basis_host``'s fixed start vector), and so give the
    same FRF and the same damped Newton iterates (``solveInverse``'s
    'newton', MSE_LOG_AFC on x = theta / theta_0), bit for bit."""
    runs = []
    for _ in range(2):
        p = pt.Problem(*_steel(pt), device="cpu")
        truth = np.asarray(p.parameters, np.float64)
        fr = p.solveForward(FREQS).numpy()
        res = p.solveInverse(truth * np.array([1.05, 1.02, 1.2]),
                             "MSE_LOG_AFC", "newton", ref_fr=(FREQS, fr),
                             use_scaling=True, report=False, log=False,
                             N_steps=3)
        runs.append((p.getFRCore()[1]["W64"].numpy(), fr,
                     np.asarray(res.x_history), np.asarray(res.f_history)))
    assert runs[0][2].shape == (3, 3)
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def sol45():
    """The SOL 45 deg Problem at n = 1466 with its own operator data, and
    the equilibrated reference pencil its band basis comes from."""
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None))
    mat = pt.get_material(1550.0, "sol", angles=(45.0,), E1=SOL_TRUE[0],
                          E2=SOL_TRUE[1], G12=SOL_TRUE[2], nu12=SOL_TRUE[3],
                          beta=SOL_TRUE[4])
    p = pt.Problem(geom, mat, acc, device="cpu")
    od = dict(p.getFRCore()[1])
    r, c, n = p.op.pattern.rows, p.op.pattern.cols, p.n_free
    ss = p._eq_scale[r] * p._eq_scale[c]
    K = sp.csc_matrix((p._reference_stiffness_flat() * ss, (r, c)), (n, n))
    M = sp.csc_matrix((p.MInertia * ss, (r, c)), (n, n))
    return p, od, 0.5 * (K + K.T), 0.5 * (M + M.T), (geom, mat, acc)


def _seeded_basis(K, M, m, seed):
    """``band_basis_host``'s basis of m modes from a seeded ARPACK start
    vector (the Problem's own start is random)."""
    v0 = np.random.default_rng(seed).standard_normal(K.shape[0])
    lam, W = spla.eigsh(K, k=m, M=M, sigma=0, which="LM", v0=v0)
    W = W[:, np.argsort(lam)]
    L = np.linalg.cholesky(W.T @ (M @ W))
    return np.ascontiguousarray(np.linalg.solve(L, W.T).T)


@pytest.mark.parametrize("seed,point", [(0, "s"), (0, "s0"), (2, "s0")])
def test_dense_tier_off_reference_meets_gate(sol45, seed, point):
    p, od, K, M, parts = sol45
    W = _seeded_basis(K, M, od["W64"].shape[1], seed)
    q = pt.Problem(*parts, device="cpu",
                   opdata=od | {"W64": torch.as_tensor(W)})
    q.getFRCore()
    assert q._tier == ("flat", "dense", False)
    th = SOL_TRUE * (S if point == "s" else S0)
    ipk = int(np.argmax(p.solveForward(SWEEP[::8], th).numpy()))
    lanes = SWEEP[max(0, 8 * ipk - 6):8 * ipk + 6]
    d = q.diagnoseSweep(lanes, th)
    ref = splu_frf(p, lanes, th)
    assert np.all(np.abs(d["fr"] - ref) <= 1e-6 * np.abs(ref))
    assert np.all(d["converged"])
