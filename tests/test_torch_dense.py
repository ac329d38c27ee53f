"""The port's dense-preconditioner tier (plate_inverse_problem_tpu_torch)
held against the JAX package on the CPU, on the small plate ``sh_i``
refine = 1, n = 1466, for both of its layouts:

* ``auto``: what ``precond="auto", operator_layout="auto"`` resolve to at
  this size, the flat f64 operator with the dense preconditioner (the
  port's Krylov basis is f64, the JAX package's f32);
* ``band_dense``: ``precond="dense", operator_layout="band"``, the RCM
  block-tridiagonal f64 operator with the same preconditioner.

Each tier's JAX Problem is built once, and every JAX output is computed
in the module's fixture, once: the FRF on both tiers, the adjoint sweep
and r, J on ``auto`` (the band layout's adjoint sweep is held against the
oracle only).  The port runs on the JAX operator data
(``opdata_from_jax``: one band basis, and the JAX package's f32 inverse
with its f32 refinement round), and on its own (its own basis and f64
inverse, ops/dense.py) against the oracle.  Tolerances:

* ``to_dense``: equal to the JAX scatter;
* ``inv_refined`` on the same f32 matrix (kappa 6.7e6): residual
  max |A X - I| and distance to the f64 inverse each at most twice the JAX
  inverse's (measured 5.2e-3 against 0.16 / 0.076, and 3.8e-8 against
  1.2e-2 / 2.5e-2, flat / band), and max |X - X_jax| within 0.1 of
  max |X_jax| (measured 1.2e-2 / 2.4e-2: the JAX f32 inverse lies that far
  from the f64 one, which the port rounds to f32); in f64 the residual is
  at most 1e-6 (measured 3.2e-11 / 4.2e-11);
* FRF: 3e-6 of max |FRF| against JAX ``getFRFunction`` (the f32
  preconditioner rounds differently on the two sides, so the FGMRES
  iterates differ — the repo's band-vs-flat tolerance), 1e-6 relative
  against the host f64 ``splu`` oracle, on both sides;
* adjoint sweep: 3e-6 of a lane's max |Y| against JAX ``sweep_adj``, 1e-6
  against ``splu_adjoint`` (the tests/test_torch_inverse.py tolerances);
* ``log_afc`` r to 3e-6, J to 1e-5 of max |J|, against JAX.
"""
import jax
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops.scatter import to_dense as jax_to_dense
from plate_inverse_problem_tpu_torch.ops import mixed as tmixed
from plate_inverse_problem_tpu_torch.ops.dense import inv_refined
from plate_inverse_problem_tpu_torch.ops.scatter import to_dense
from plate_inverse_problem_tpu_torch.oracle import splu_adjoint, splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)
MAT = dict(E=200e9, G=75e9, beta=0.003)
FREQS = np.linspace(60.0, 420.0, 8)   # includes the ~152 Hz resonance
START = np.array([1.05, 1.02, 1.2])   # theta_0 / truth of the adjoint checks
# the tier each resolves to: JAX's layout and preconditioner, and the
# port's f64 Krylov basis (JAX's is f32 on these tiers)
TIERS = {"auto": ({}, ("flat", "dense", False)),
         "band_dense": ({"precond": "dense", "operator_layout": "band"},
                        ("band", "dense", False))}


def _port_problem(od=None, **kw):
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", **MAT)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), refine=1.0)
    opdata = None if od is None else pt.opdata_from_jax(od, "cpu")
    return pt.Problem(geom, mat, acc, device="cpu", opdata=opdata, **kw)


def _jax_tier(name):
    """The JAX Problem of one tier, its operator data in numpy, its FRF at
    the truth, and the port's Problem on that operator data."""
    kw, resolved = TIERS[name]
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", **MAT)
    geom = pip.Geometry("sh_i", acc, pip.GeometryParams(*GP), refine=1.0)
    pj = pip.Problem(geom, mat, acc, engine="mixed", **kw)
    y = np.asarray(pj.getFRFunction()(FREQS, np.asarray(pj.parameters)))
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    pp = _port_problem(od, **kw)
    pp.getFRCore()
    return {"kw": kw, "resolved": resolved, "pj": pj, "od": od, "pp": pp,
            "y": y}


@pytest.fixture(scope="module")
def tiers():
    """Both tiers, and on ``auto`` the JAX adjoint sweep and log_afc r, J at
    theta_0 = truth x START against the FRF at the truth.  The adjoint
    right-hand side G = dr/dU of log_afc comes from the port's primal sweep
    (one pullback at the all-ones cotangent)."""
    out = {name: _jax_tier(name) for name in TIERS}
    t = out["auto"]
    pj, pp, y = t["pj"], t["pp"], t["y"]
    th0 = np.asarray(pj.parameters) * START
    core, od_t = pp.getFRCore()
    U_re, U_im = core.sweep_u(torch.as_tensor(FREQS), torch.as_tensor(th0),
                              od_t)
    Ur = U_re.clone().requires_grad_(True)
    Ui = U_im.clone().requires_grad_(True)
    r = torch.log(core.readout_ui(Ur, Ui, od_t)) - torch.log(torch.tensor(y))
    G = tuple(g.numpy() for g in torch.autograd.grad(
        r, (Ur, Ui), torch.ones_like(r)))
    core_j, od_j = pj.getFRCore()
    t["Y"] = tuple(np.asarray(v) for v in jax.jit(core_j.sweep_adj)(
        FREQS, th0, od_j, *G))
    t["rj"], t["Jj"] = (np.asarray(v) for v in pj.getResidualFunction(
        FREQS, y, kind="log_afc").value_and_jac(th0))
    t["G"], t["th0"] = G, th0
    return out


def _lane_err(a, b):
    """Per-lane max |a - b| over the lane's max |b| (complex pairs)."""
    d = np.abs((a[0] - b[0]) + 1j * (a[1] - b[1])).max(axis=1)
    return d / np.abs(b[0] + 1j * b[1]).max(axis=1)


@pytest.mark.parametrize("name", list(TIERS))
def test_tier_resolves_as_jax(tiers, name):
    """Without opdata (the port builds its own: its ARPACK basis, its f64
    inverse), the arguments resolve to the JAX Problem's tier (flat + dense
    below 8192 DOF under 'auto'; the Krylov basis f64) and the FRF meets
    the oracle."""
    tier = tiers[name]
    p = _port_problem(**tier["kw"])
    od = p.getFRCore()[1]
    assert p._tier == tier["resolved"]
    assert (p._band_layout is None) == (tier["pj"]._band_layout is None)
    assert tier["pj"]._precond_resolved == "dense"
    assert od["invK64"].dtype == torch.float64
    assert od["invK64"].shape == (p.n_free, p.n_free)
    assert not any(k.startswith("mg_") or k.endswith("32") for k in od)
    y = p.solveForward(FREQS).numpy()
    ref = splu_frf(p, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)


@pytest.mark.parametrize("name", list(TIERS))
def test_to_dense_equals_jax(tiers, name):
    tier = tiers[name]
    od = tier["od"]
    n = tier["pp"].n_free
    ref = np.asarray(jax_to_dense(od["Kref32"], od["rows"], od["cols"], n))
    out = to_dense(torch.tensor(od["Kref32"]), torch.tensor(od["rows"]),
                   torch.tensor(od["cols"]), n)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", list(TIERS))
def test_inv_refined_matches_jax(tiers, name):
    tier = tiers[name]
    od = tier["od"]
    n = tier["pp"].n_free
    A = to_dense(torch.tensor(od["Kref32"]), torch.tensor(od["rows"]),
                 torch.tensor(od["cols"]), n)
    X = inv_refined(A)
    assert X.dtype == torch.float32
    Xj = od["invK32"]
    A64 = A.numpy().astype(np.float64)

    X64 = np.linalg.inv(A64)

    def residual(X):
        return np.abs(A64 @ X.astype(np.float64) - np.eye(n)).max()

    def dist(X, Y):
        return np.abs(X - Y).max() / np.abs(Y).max()

    X = X.numpy()
    assert residual(X) <= 2.0 * residual(Xj)
    assert dist(X, X64) <= 2.0 * dist(Xj, X64)
    assert dist(X, Xj) <= 0.1
    X = inv_refined(A.double())
    assert X.dtype == torch.float64
    assert residual(X.numpy()) <= 1e-6


@pytest.mark.parametrize("name", list(TIERS))
def test_solve_forward_matches_jax_and_oracle(tiers, name):
    tier = tiers[name]
    pp, y_jax = tier["pp"], tier["y"]
    y = pp.solveForward(FREQS)
    assert y.dtype == torch.float64 and y.shape == (FREQS.size,)
    y = y.numpy()
    assert np.all(np.isfinite(y))
    assert np.abs(y - y_jax).max() / np.abs(y_jax).max() <= 3e-6
    ref = splu_frf(pp, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)
    assert np.all(np.abs(y_jax - ref) <= 1e-6 * ref)


@pytest.mark.parametrize("name", list(TIERS))
def test_adjoint_sweep_matches_jax_and_oracle(tiers, name):
    """The adjoint sweep on the G of ``auto`` (the flat layout's order): on
    ``band_dense`` G is permuted into the band order first."""
    auto, tier = tiers["auto"], tiers[name]
    pp, th0 = tier["pp"], auto["th0"]
    lay = pp._band_layout
    G = auto["G"] if lay is None else tuple(g[:, lay.perm] for g in auto["G"])
    core, od = pp.getFRCore()
    Yt = tuple(v.numpy() for v in core.sweep_adj(
        torch.as_tensor(FREQS), torch.as_tensor(th0), od,
        *(torch.as_tensor(g) for g in G)))
    assert Yt[0].shape == (FREQS.size, pp.n_free)
    assert np.all(np.isfinite(Yt[0])) and np.all(np.isfinite(Yt[1]))
    Yo = splu_adjoint(pp, FREQS, *G, th0)
    assert np.all(_lane_err(Yt, Yo) <= 1e-6)
    if lay is None:
        Yj = auto["Y"]
        assert np.all(_lane_err(Yt, Yj) <= 3e-6)
        assert np.all(_lane_err(Yj, Yo) <= 1e-6)


def test_log_afc_value_and_jac_matches_jax(tiers):
    tier = tiers["auto"]
    pp, th0 = tier["pp"], tier["th0"]
    rf = pp.getResidualFunction(FREQS, tier["y"], kind="log_afc")
    r, J = (v.numpy() for v in rf.value_and_jac(th0))
    assert r.shape == (FREQS.size,) and J.shape == (FREQS.size, 3)
    assert np.abs(r - tier["rj"]).max() <= 3e-6
    assert np.abs(J - tier["Jj"]).max() <= 1e-5 * np.abs(tier["Jj"]).max()


@pytest.mark.parametrize("name", list(TIERS))
def test_f64_basis_meets_oracle(tiers, name):
    """``basis_f32=False`` keeps the Krylov bases in f64 (the default) and
    ``basis_f32=True`` in f32 (the JAX package's on this tier): the FRF
    meets the oracle either way, on the port's own operator data."""
    tier = tiers[name]
    for f32 in (False, True):
        pp = _port_problem(basis_f32=f32, **tier["kw"])
        pp.getFRCore()
        assert pp._tier == tier["resolved"][:2] + (f32,)
        y = pp.solveForward(FREQS).numpy()
        ref = splu_frf(pp, FREQS)
        assert np.all(np.abs(y - ref) <= 1e-6 * ref)


def test_segmented_flat_applies_equal_one_pass(tiers, monkeypatch):
    """Above 2 * _RES_SEG entries the sweep's fused K/M scatter and its
    residual-grade apply walk the pattern in _RES_SEG segments (n = 11910
    on the card has 290,688): with 5000-entry segments (7 of them) the CPU
    sweep gives the one-pass result exactly (index_add_ sums each row in
    entry order either way)."""
    pp = tiers["auto"]["pp"]
    y = pp.solveForward(FREQS).numpy()
    monkeypatch.setattr(tmixed, "_RES_SEG", 5000)
    np.testing.assert_array_equal(pp.solveForward(FREQS).numpy(), y)
