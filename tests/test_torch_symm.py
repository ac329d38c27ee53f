"""The port's symmetric operator, the band two-grid tier of the new paths,
laminate coupling and setup folders (plate_inverse_problem_tpu_torch), on
the CPU, with no JAX mixed-engine compile:

* ``assemble_symm`` and ``_w_constraints`` EQUAL to the JAX package's,
  with and without the accelerometer indicator;
* the port alone against the host f64 ``splu`` oracle at 1e-6: the band
  layout with the two-grid (``precond="mg"``, K1's plain version here) on
  ``sh_i`` refine = 1 for ``OrthotropicD4`` (the per-modulus band
  branches) and the pure-bending path (the Morley prolongation, coarse
  constraints from ``_w_constraints``); a non-palindromic SOL stack (B !=
  0) on the 3-field path;
* a ``spath`` Problem from ``setups/example_steel_strip`` equal to the one
  built by hand, and the reference FRF read from a setup folder.
"""
import json
import pathlib

import numpy as np
import pytest

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.fem import assembly as jassembly
from plate_inverse_problem_tpu_torch.fem import assembly as tassembly
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = 2e-3
GP_SYMM = (100e-3, 20e-3, 2e-3, 10e-3, None)   # tests/test_problem.py
GP_SH_I = (100e-3, 20e-3, 2e-3, None, None)
FREQS = np.linspace(40.0, 500.0, 8)
SOL_0_45 = dict(E1=150e9, E2=9e9, G12=5e9, nu12=0.3, beta=0.01,
                angles=(0.0, 45.0))

# the engine cases: (atype, moduli, density, accelerometer on the Problem)
CASES = {
    "sol45": ("sol", dict(E1=120e9, E2=8.5e9, G12=4.5e9, nu12=0.30,
                          beta=0.006, angles=(45.0,)), 1550.0, True),
    "d4": ("orthotropic_d4", dict(E1=210e9, E2=200e9, G12=75e9, nu12=0.33,
                                  b1=0.003, b2=0.003, b3=0.004, b4=0.0),
           7920.0, True),
    "symm": ("isotropic", dict(E=200e9, G=75e9, beta=0.003), 7920.0, False),
}
D4_START = np.array([1.02, 0.98, 1.03, 0.97, 1.1, 0.9, 1.05, 1.0])


def _parts(mod, case, gp=GP_SYMM, **geom_kw):
    atype, kw, rho, with_acc = CASES[case]
    acc = mod.Accelerometer("AP1030")
    if "ny" not in geom_kw and "refine" not in geom_kw:
        geom_kw = {"ny": 1}
    geom = mod.Geometry("symm" if gp is GP_SYMM else "sh_i", acc,
                        mod.GeometryParams(*gp), **geom_kw)
    return geom, mod.get_material(rho, atype, **kw), (acc if with_acc
                                                       else None)



@pytest.mark.parametrize("indicator", [True, False])
def test_assemble_symm_equals_jax(indicator):
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP_SH_I), refine=0.7)
    mesh = geom.get_mesh()
    ind = (tassembly.accel_indicator(geom.accel_x, geom.accel_y,
                                     geom.accel_r) if indicator else None)
    ot = tassembly.assemble_symm(mesh, geom.test_point, indicator=ind)
    oj = jassembly.assemble_symm(mesh, geom.test_point, indicator=ind)
    for f in ("Ks", "M", "L", "MCorrection", "LCorrection", "fKs", "fM",
              "fL", "fMCorrection", "fLCorrection", "interpolation_vector",
              "free_idx", "constrained", "boundary_value"):
        np.testing.assert_array_equal(getattr(ot, f), getattr(oj, f), f)
    np.testing.assert_array_equal(ot.pattern.rows, oj.pattern.rows)
    np.testing.assert_array_equal(ot.pattern.cols, oj.pattern.cols)
    assert ot.interpolation_value_from_bc == oj.interpolation_value_from_bc
    assert (ot.n_free, ot.n_dofs_full) == (oj.n_free, oj.n_dofs_full)
    assert np.abs(ot.MCorrection).max() > 0 if indicator else \
        not ot.MCorrection.any()
    c, g = tassembly._w_constraints(mesh, (1,))
    cj, gj = jassembly._w_constraints(mesh, (1,))
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(g, gj)


@pytest.mark.parametrize("case", ["d4", "symm"])
def test_band_two_grid_matches_oracle(case):
    """The band layout with the two-grid (K1's plain version here) on
    ``sh_i`` refine = 1: the per-modulus band branches (K_im band, its
    projections and residual grade) and the pure-bending two-grid (Morley
    prolongation, coarse constraints from ``_w_constraints``)."""
    p = pt.Problem(*_parts(pt, case, GP_SH_I, refine=1.0), device="cpu",
                   precond="mg", operator_layout="band")
    freqs = np.linspace(60.0, 420.0, 6)
    y = p.solveForward(freqs).numpy()
    assert p._tier == ("band", "mg", False)
    assert p.n_free == (956 if case == "symm" else 1466)
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))


def test_non_palindromic_sol_couples_membrane_and_bending():
    """A SOL stack (0, 45) is not mid-plane symmetric: B != 0 and it runs
    the 3-field path; without an accelerometer it has no readout, so the
    Problem refuses it."""
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc, pt.GeometryParams(*GP_SYMM), ny=1)
    mat = pt.get_material(1600.0, "sol", **SOL_0_45)
    p = pt.Problem(geom, mat, acc, device="cpu")
    assert not p.is_symmetric_path
    _, Bv, _ = mat.reference_coeffs(p.parameters, H)
    assert np.abs(Bv).max() > 0.0
    y = p.solveForward(FREQS).numpy()
    ref = splu_frf(p, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)
    with pytest.raises(ValueError, match="accelerometer"):
        pt.Problem(geom, mat, None, device="cpu")


def test_spath_problem_equals_by_hand(tmp_path):
    p = pt.Problem(spath="example_steel_strip", device="cpu")
    setup = json.loads((pathlib.Path(__file__).parents[1] / "setups"
                        / "example_steel_strip" / "setup.json").read_text())
    g = dict(setup["geometry"])
    acc = pt.Accelerometer(setup["accelerometer"])
    geom = pt.Geometry(g.pop("template"), acc, pt.GeometryParams(**g))
    q = pt.Problem(geom, pt.get_material(setup["material"]), acc,
                   device="cpu")
    assert p.accelerometer.__dict__ == q.accelerometer.__dict__
    assert type(p.material) is type(q.material)
    assert p.material.get_save_dict() == q.material.get_save_dict()
    assert p.n_free == q.n_free
    np.testing.assert_array_equal(p.mesh.nodes, q.mesh.nodes)
    np.testing.assert_array_equal(p.op.pattern.rows, q.op.pattern.rows)
    for k in q.op.mats:
        np.testing.assert_array_equal(p.op.mats[k], q.op.mats[k])
    np.testing.assert_array_equal(p.MInertia, q.MInertia)
    assert not hasattr(p, "reference_fr")
    # a copy with reference data: the FRF of freqs.npy / amp.npy / phase.npy
    sdir = tmp_path / "case"
    sdir.mkdir()
    (sdir / "setup.json").write_text(json.dumps(setup))
    np.save(sdir / "freqs.npy", FREQS)
    np.save(sdir / "amp.npy", np.ones(FREQS.size))
    np.save(sdir / "phase.npy", np.full(FREQS.size, 0.5))
    r = pt.Problem(spath=str(sdir), device="cpu")
    np.testing.assert_array_equal(r.reference_fr[0], FREQS)
    np.testing.assert_array_equal(r.reference_fr[1],
                                  np.exp(0.5j) * np.ones(FREQS.size))
