"""The port's material families (plate_inverse_problem_tpu_torch/models/
materials.py) held against the JAX package on the CPU, host layer only (no
JAX mixed-engine compile):

* the split transforms ``abd_split`` / ``d_split`` of all five families
  (and a non-palindromic SOL stack) against JAX ``get_ABD_transform_split``
  / ``get_D_transform_split`` at parameters drawn from a numpy seed: 1e-15
  of the largest modulus (the same f64 operations; measured equal);
  ``reference_coeffs`` / ``reference_d`` against the real parts of the
  complex transforms (1e-15); ``q_to_abd_matrices`` equal;
* ``get_material`` every way (kwargs, dict, ``.json`` path, package name)
  and its error cases as tests/test_materials.py makes them (the same
  exception type as JAX); the constraints (check, matrices, and the
  nonlinear one's value, jacobian and hessian against JAX's AD to 1e-12);
  ``save_to_file`` / ``create_accelerometer`` files equal.
"""
import json

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.models import accelerometer as jaccel
from plate_inverse_problem_tpu.models import materials as jmat
from plate_inverse_problem_tpu_torch.models import accelerometer as taccel
from plate_inverse_problem_tpu_torch.models import materials as tmat
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = 2e-3

# (atype, nominal moduli, density); the transform tests draw theta around
# the nominal values from a numpy seed
FAMILIES = {
    "iso": ("isotropic", dict(E=200e9, G=75e9, beta=0.003), 7920.0),
    "ortho": ("orthotropic", dict(E1=150e9, E2=9e9, G12=5e9, nu12=0.3,
                                  beta=0.01), 1600.0),
    "ortho_d4": ("orthotropic_d4", dict(E1=150e9, E2=9e9, G12=5e9, nu12=0.3,
                                        b1=0.01, b2=0.02, b3=0.015,
                                        b4=0.005), 1600.0),
    "sol": ("sol", dict(E1=150e9, E2=9e9, G12=5e9, nu12=0.3, beta=0.01,
                        angles=(0.0, 45.0, 45.0, 0.0)), 1600.0),
    "sol_0_45": ("sol", dict(E1=150e9, E2=9e9, G12=5e9, nu12=0.3, beta=0.01,
                             angles=(0.0, 45.0)), 1600.0),
    "symm_sol": ("symm_sol", dict(E1=150e9, G12=5e9, nu12=0.3, beta=0.01,
                                  angles=(0.0, 90.0, 90.0, 0.0)), 1600.0),
}


def _materials(name, seed=0):
    """(JAX material, port material) of family ``name`` at moduli drawn
    within +-10 % of the nominal ones (loss factors within +-50 %)."""
    atype, kw, rho = FAMILIES[name]
    rng = np.random.default_rng(seed)
    kw = {k: (v if k == "angles" else
              float(v * (1.0 + (0.5 if k[0] == "b" else 0.1)
                         * rng.uniform(-1.0, 1.0))))
          for k, v in kw.items()}
    return (pip.get_material(rho, atype, **kw),
            pt.get_material(rho, atype, **kw))


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_split_transforms_match_jax(name):
    mj, mt = _materials(name, seed=len(name))
    assert type(mt).__name__ == type(mj).__name__
    assert mt.is_mps == mj.is_mps
    assert mt.scalar_loss_factor == mj.scalar_loss_factor
    th = np.array(mj.get_parameters(), np.float64)
    np.testing.assert_array_equal(mt.get_parameters(), th)
    tt = torch.as_tensor(th)
    out = mt.abd_split(tt, H)
    for (jre, jim), (tre, tim) in zip(
            mj.get_ABD_transform_split(H)(th, 0.0), out):
        scale = max(np.abs(np.asarray(jre)).max(), 1e-300)
        for x, y in ((jre, tre), (jim, tim)):
            assert y.dtype == torch.float64
            assert np.abs(y.numpy() - np.asarray(x)).max() <= 1e-15 * scale
    for x, y in zip(mj.get_ABD_transform(H)(th, 0.0),
                    mt.reference_coeffs(th, H)):
        assert _rel(y, np.asarray(x).real) <= 1e-15
    if name == "sol_0_45":      # not mid-plane symmetric: B couples
        assert np.abs(out[1][0].numpy()).max() > 0.0
        return
    for x, y in zip(mj.get_D_transform_split(H)(th, 0.0), mt.d_split(tt, H)):
        assert _rel(y.numpy(), x) <= 1e-15
    assert _rel(mt.reference_d(th, H),
                np.asarray(mj.get_D_transform(H)(th, 0.0)).real) <= 1e-15


def test_q_to_abd_matrices_equal():
    rng = np.random.default_rng(3)
    for nl in (1, 2, 3, 5):
        angles = rng.uniform(-90.0, 90.0, nl)
        h = 1e-3 * (1.0 + rng.uniform())
        for a, b in zip(tmat.q_to_abd_matrices(angles, h),
                        jmat.q_to_abd_matrices(angles, h)):
            np.testing.assert_array_equal(a, b)
        q6 = rng.standard_normal(6)
        np.testing.assert_array_equal(tmat._qbar_components(q6, angles[0]),
                                      jmat._qbar_components(q6, angles[0]))


def _same_material(mt, mj):
    assert type(mt).__name__ == type(mj).__name__
    assert mt.density == mj.density
    np.testing.assert_array_equal(mt.get_parameters(),
                                  np.asarray(mj.get_parameters()))
    assert mt.get_save_dict() == mj.get_save_dict()


def test_get_material_every_way(tmp_path):
    for name in sorted(FAMILIES):
        atype, kw, rho = FAMILIES[name]
        _same_material(pt.get_material(rho, atype, **kw),
                       pip.get_material(rho, atype, **kw))
        d = dict(kw, density=rho, atype=atype, is_mps=True)
        _same_material(pt.get_material(d), pip.get_material(d))
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(dict(d, angles=list(kw["angles"]))
                                   if "angles" in kw else d))
        _same_material(pt.get_material(str(path)),
                       pip.get_material(str(path)))
    _same_material(pt.get_material("Example_material"),
                   pip.get_material("Example_material"))


def _error_cases(tmp_path):
    nokey = tmp_path / "nokey.json"
    nokey.write_text(json.dumps({"atype": "isotropic", "E": 1.0}))
    return {
        "negative_density": ((-5.0, "isotropic"), {}),
        "bogus_atype": ((100.0, "bogus"), {}),
        "wrong_kwarg": ((100.0, "isotropic"), {"WRONG": 1.0}),
        "sol_without_angles": ((100.0, "sol"), {"E1": 1.0}),
        "no_atype": ((100.0,), {"E": 1.0}),
        "dict_without_atype": (({"density": 1.0, "E": 1.0},), {}),
        "bad_type": (([1.0],), {}),
        "bad_extension": (("steel.txt",), {}),
        "missing_file": ((str(tmp_path / "none.json"),), {}),
        "json_without_density": ((str(nokey),), {}),
    }



def test_get_material_errors_match_jax(tmp_path):
    for case, (args, kw) in _error_cases(tmp_path).items():
        with pytest.raises(Exception) as ej:
            pip.get_material(*args, **kw)
        with pytest.raises(ej.type):
            pt.get_material(*args, **kw)


def test_constraints_match_jax():
    for name in ("iso", "ortho", "ortho_d4", "sol", "symm_sol"):
        _constraints_match_jax(name)


def _constraints_match_jax(name):
    mj, mt = _materials(name, seed=7)
    cj, ct = type(mj), type(mt)
    rng = np.random.default_rng(11)
    th = np.asarray(mj.get_parameters(), np.float64)
    for scale in (1.0, th * rng.uniform(0.5, 1.5, th.size)):
        pts = [th / scale] + [th / scale * rng.uniform(0.2, 3.0, th.size)
                              for _ in range(20)]
        pts.append(-pts[0])
        for x in pts:
            assert ct.check_parameters(x, scale) == cj.check_parameters(
                x, scale)
        cons_j = cj.get_constraints(None if np.isscalar(scale) else scale)
        cons_t = ct.get_constraints(None if np.isscalar(scale) else scale)
        if cons_j is None:
            assert cons_t is None
            continue
        cons_j = cons_j if isinstance(cons_j, list) else [cons_j]
        cons_t = cons_t if isinstance(cons_t, list) else [cons_t]
        assert [type(c) for c in cons_t] == [type(c) for c in cons_j]
        for c_t, c_j in zip(cons_t, cons_j):
            np.testing.assert_array_equal(c_t.lb, c_j.lb)
            np.testing.assert_array_equal(c_t.ub, c_j.ub)
            if hasattr(c_j, "A"):
                np.testing.assert_array_equal(c_t.A, c_j.A)
                continue
            v = np.array([0.7])
            for x in pts[:5]:
                np.testing.assert_allclose(c_t.fun(x), np.asarray(c_j.fun(x)),
                                           rtol=1e-14)
                np.testing.assert_allclose(c_t.jac(x), np.asarray(c_j.jac(x)),
                                           rtol=1e-12, atol=0)
                np.testing.assert_allclose(
                    c_t.hess(x, v), np.asarray(c_j.hess(x, v)), rtol=1e-12,
                    atol=1e-12 * np.abs(np.asarray(c_j.hess(x, v))).max())



def test_save_to_file_round_trip(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(jmat, "get_package_dir", lambda: str(tmp_path / "jax"))
    monkeypatch.setattr(tmat, "get_package_dir",
                        lambda: str(tmp_path / "port"))
    for name in sorted(FAMILIES):
        mj, mt = _materials(name, seed=5)
        mj.save_to_file(name)
        mt.save_to_file(name)
        saved = [json.loads((tmp_path / d / "materials" / f"{name}.json")
                            .read_text()) for d in ("jax", "port")]
        assert saved[1] == saved[0]
        _same_material(pt.get_material(name), mj)


def test_create_accelerometer_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(jaccel, "get_package_dir",
                        lambda: str(tmp_path / "jax"))
    monkeypatch.setattr(taccel, "get_package_dir",
                        lambda: str(tmp_path / "port"))
    kw = dict(mass=0.002, radius=3e-3, height=4e-3, effective_height=0.4,
              transverse_sensitivity=0.03)
    pip.Accelerometer.create_accelerometer(pip.AccelerometerParams(**kw), "A")
    pt.Accelerometer.create_accelerometer(pt.AccelerometerParams(**kw), "A")
    saved = [json.loads((tmp_path / d / "accelerometers" / "A.json")
                        .read_text()) for d in ("jax", "port")]
    assert saved[1] == saved[0] == kw
    assert pt.Accelerometer("A").__dict__ == kw
