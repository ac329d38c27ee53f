"""The port's Problem (plate_inverse_problem_tpu_torch) held against the JAX
package on the CPU, on the small band + two-grid plate: ``sh_i`` refine = 1,
n = 1466, b = 256, nb = 6, n_c = 470.

* The host layer is a copy: pattern, operator data, lifts, readout rows,
  band layouts and the coarse operator must be EQUAL to the JAX package's.
* The split material transform agrees to 1e-15 relative (f64 rounding of
  the same few operations, fused differently).
* ``solveForward`` agrees with JAX ``getFRFunction`` to 3e-6 relative on
  the JAX operator data (different f32 preconditioner roundoff gives
  different FGMRES iterates — the repo's band-vs-flat tolerance,
  test_band.py:149-151), and both stay within 1e-6 of a host f64 splu
  oracle.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)
FREQS = np.linspace(60.0, 420.0, 8)   # includes the ~152 Hz resonance
MAT = dict(E=200e9, G=75e9, beta=0.003)


def _port_parts(refine=1.0):
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", **MAT)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), refine=refine)
    return geom, mat, acc


@pytest.fixture(scope="module")
def jax_problem():
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", **MAT)
    geom = pip.Geometry("sh_i", acc, pip.GeometryParams(*GP), refine=1.0)
    pj = pip.Problem(geom, mat, acc, engine="mixed", precond="mg",
                     operator_layout="band")
    y = np.asarray(pj.getFRFunction()(FREQS, np.asarray(pj.parameters)))
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    return pj, od, y


@pytest.fixture(scope="module")
def port_problem():
    p = pt.Problem(*_port_parts(), device="cpu", precond="mg",
                   operator_layout="band")
    p.getFRCore()
    return p


def test_host_layer_equals_jax(jax_problem, port_problem):
    pj, _, _ = jax_problem
    pp = port_problem
    assert pp.n_free == pj.n_free == 1466
    np.testing.assert_array_equal(pp.mesh.nodes, pj.mesh.nodes)
    np.testing.assert_array_equal(pp.mesh.triangles, pj.mesh.triangles)
    np.testing.assert_array_equal(pp.op.pattern.rows, pj.op.pattern.rows)
    np.testing.assert_array_equal(pp.op.pattern.cols, pj.op.pattern.cols)
    assert pp.op.mats.keys() == pj.op.mats.keys()
    for k in pj.op.mats:
        np.testing.assert_array_equal(pp.op.mats[k], pj.op.mats[k])
        np.testing.assert_array_equal(pp.op.lifts[k], pj.op.lifts[k])
    for k, (R, r0) in pj.op.readout.items():
        np.testing.assert_array_equal(pp.op.readout[k][0], R)
        np.testing.assert_array_equal(pp.op.readout[k][1], r0)
    np.testing.assert_array_equal(pp.MInertia, pj.MInertia)
    np.testing.assert_array_equal(pp.fInertia, pj.fInertia)
    np.testing.assert_array_equal(pp._reference_stiffness_flat(),
                                  pj._reference_stiffness_flat())
    np.testing.assert_array_equal(pp._eq_scale, pj._eq_scale)


def test_band_and_two_grid_layouts_equal_jax(jax_problem, port_problem):
    pj, _, _ = jax_problem
    pp = port_problem
    lj, lt = pj._band_layout, pp._band_layout
    assert (lt.b, lt.nb) == (lj.b, lj.nb) == (256, 6)
    np.testing.assert_array_equal(lt.perm, lj.perm)
    np.testing.assert_array_equal(lt.lin, lj.lin)
    for f in ("n_fine", "n_coarse", "nb", "b", "bc", "nd", "hw", "perm_c",
              "slots", "lin", "vals"):
        np.testing.assert_array_equal(getattr(pp._mg_rl, f),
                                      getattr(pj._mg_rl, f))
    assert pp._mg_rl.n_coarse == 470
    assert (pp._mg_Kc != pj._mg_Kc).nnz == 0
    assert pp._mg_lmax == pj._mg_lmax


def test_opdata_equals_jax(jax_problem, port_problem):
    """The port's own operator data equals the JAX opdata, except the
    band basis (ARPACK's random start vector)."""
    _, od, _ = jax_problem
    ot = port_problem.getFRCore()[1]
    conv = pt.opdata_from_jax(od, "cpu")
    assert conv.keys() == ot.keys()
    for k, v in ot.items():
        assert v.dtype == conv[k].dtype, k
        if k != "W64":
            np.testing.assert_array_equal(v.numpy(), conv[k].numpy(), k)
    assert ot["W64"].shape == conv["W64"].shape


@pytest.mark.parametrize("theta", [[200e9, 75e9, 0.003],
                                   [210e9, 80e9, 0.01]])
def test_split_transform_matches_jax(theta):
    h = 2e-3
    mj = pip.get_material(7920.0, "isotropic", **MAT)
    mt = pt.get_material(7920.0, "isotropic", **MAT)
    ref = mj.get_ABD_transform_split(h)(np.asarray(theta), 0.0)
    out = mt.abd_split(torch.tensor(theta, dtype=torch.float64), h)
    for (aj, bj), (at, bt) in zip(ref, out):
        for x, y in ((aj, at), (bj, bt)):
            x = np.asarray(x)
            y = y.numpy()
            assert np.abs(y - x).max() <= 1e-15 * max(np.abs(x).max(), 1e-300)
    # the reference-stiffness coefficients follow the complex transform
    cj = mj.get_ABD_transform(h)(np.asarray(theta), 0.0)
    for x, y in zip(cj, mt.reference_coeffs(np.asarray(theta), h)):
        np.testing.assert_array_equal(y, np.asarray(x).real)


def test_solve_forward_matches_jax_and_oracle(jax_problem):
    pj, od, y_jax = jax_problem
    geom, mat, acc = _port_parts()
    p = pt.Problem(geom, mat, acc, device="cpu", precond="mg",
                   operator_layout="band",
                   opdata=pt.opdata_from_jax(od, "cpu"))
    y = p.solveForward(FREQS)
    assert y.dtype == torch.float64 and y.shape == (FREQS.size,)
    y = y.numpy()
    assert np.all(np.isfinite(y))
    assert np.abs(y - y_jax).max() / np.abs(y_jax).max() <= 3e-6
    ref = splu_frf(p, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)
    assert np.all(np.abs(y_jax - ref) <= 1e-6 * ref)


def test_solve_forward_own_basis_matches_oracle(port_problem):
    """End to end on the port's own operator data (its own ARPACK basis),
    through the public entry points only."""
    y = port_problem.solveForward(FREQS).numpy()
    ref = splu_frf(port_problem, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)
    fn = port_problem.getFRFunction()
    y2 = fn(FREQS[2:4], port_problem.parameters * 1.01).numpy()
    ref2 = splu_frf(port_problem, FREQS[2:4], port_problem.parameters * 1.01)
    assert np.all(np.abs(y2 - ref2) <= 1e-6 * ref2)


@pytest.mark.parametrize("kw", [
    {"precond": "dense", "operator_layout": "band"},
    {"precond": "mg", "operator_layout": "flat"},
    {},   # 'auto' on this small plate resolves to flat + dense
])
def test_unported_tiers_raise(kw):
    """The tier combinations the port once refused now build on their own
    operator data and meet the splu oracle to 1e-6: the two dense ones,
    and (flat, mg), the flat multilevel preconditioner (on the refine = 1
    plate: the refine = 0.5 one has no coarser level to build)."""
    mg = kw.get("precond") == "mg"
    p = pt.Problem(*_port_parts(refine=1.0 if mg else 0.5), device="cpu",
                   **kw)
    if mg:
        p.getFRCore()
        assert p._tier[:2] == ("flat", "mg")
        assert len(p._multilevel["levels"]) == 1
    freqs = FREQS[::3]
    y = p.solveForward(freqs).numpy()
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)


@pytest.mark.parametrize("kw", [{"engine": "modal"}, {"basis": "lobpcg"}])
def test_unported_options_raise(kw):
    """The options the port once refused are ported: engine='modal' builds
    the modal engine, which meets the splu oracle to 1e-9 (an exact f64
    solve); basis='lobpcg' builds the LOBPCG band basis (the dense tier at
    n = 470), and the mixed sweep on it meets the oracle to 1e-6."""
    p = pt.Problem(*_port_parts(refine=0.5), device="cpu", **kw)
    freqs = FREQS[::3]
    y = p.solveForward(freqs).numpy()
    ref = splu_frf(p, freqs)
    if "engine" in kw:
        assert p.getFRCore()[0].engine == "modal"
        assert np.all(np.abs(y - ref) <= 1e-9 * ref)
        return
    assert p._basis_resolved == "lobpcg"
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)


class _FreqDepIsotropic(pt.Isotropic):
    """A custom material whose loss factor grows with the frequency,
    beta (1 + omega / omega_ref) (tests/test_problem.py's)."""

    def abd_split(self, params, h, omega=0.0):
        b = params[2] * (1.0 + omega / (2.0 * np.pi * 300.0))
        return super().abd_split(torch.stack([params[0], params[1], b]), h)


def test_unported_paths_raise(tmp_path):
    """The paths the port once refused: the pure-bending path (no
    accelerometer) and the other material families now build and meet the
    splu oracle to 1e-6.  A material whose transform depends on the
    frequency warns and runs the direct engine (the JAX package's fallback),
    which meets the per-frequency splu oracle to 1e-9.  A setup folder whose geometry is an .edp script
    (item B, ported) now loads; one naming a missing .msh file raises
    FileNotFoundError."""
    geom, mat, acc = _port_parts(refine=0.5)
    freqs = FREQS[::3]
    p = pt.Problem(geom, mat, None, device="cpu")     # symmetric path
    ortho = pt.get_material(1500.0, "orthotropic", E1=1e10, E2=5e9, G12=3e9,
                            nu12=0.3, beta=0.01)
    q = pt.Problem(geom, ortho, acc, device="cpu")
    assert p.is_symmetric_path and not q.is_symmetric_path
    for r in (p, q):
        y = r.solveForward(freqs).numpy()
        ref = splu_frf(r, freqs)
        assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))
    fd = pt.Problem(geom, _FreqDepIsotropic(7920.0, **MAT), acc,
                    device="cpu")
    with pytest.warns(RuntimeWarning, match="frequency-dependent"):
        assert fd.getFRCore()[0].engine == "direct"
    y = fd.solveForward(freqs).numpy()
    ref = splu_frf(fd, freqs)
    assert np.all(np.abs(y - ref) <= 1e-9 * ref)
    sdir = tmp_path / "edp_setup"
    sdir.mkdir()
    (sdir / "plate.edp").write_text(
        "real Lx = 0.1; real Ly = 0.02; int n = 6;\n"
        "border B1(t=0, 1){x=Lx*t; y=0; label=0;}\n"
        "border B2(t=0, 1){x=Lx; y=Ly*t; label=1;}\n"
        "border B3(t=0, 1){x=Lx*(1-t); y=Ly; label=0;}\n"
        "border B4(t=0, 1){x=0; y=Ly*(1-t); label=0;}\n"
        "mesh Th = buildmesh(B1(5*n) + B2(n) + B3(5*n) + B4(n));\n")
    (sdir / "setup.json").write_text(
        '{"geometry": {"edp": "plate.edp", "length": 0.1, "width": 0.02, '
        '"height": 0.002, "accel_x": 0.01, "accel_y": 0.0}, '
        '"material": "Example_material", "accelerometer": "AP1030"}')
    e = pt.Problem(spath=str(sdir), device="cpu")
    assert e.geometry.current_file == str(sdir / "plate.edp")
    assert e.geometry.clamped_labels == (1,) and e.geometry.can_coarsen
    (sdir / "setup.json").write_text(
        '{"geometry": {"msh": "missing.msh", "height": 0.002}, '
        '"material": "Example_material", "accelerometer": "AP1030"}')
    with pytest.raises(FileNotFoundError):
        pt.Problem(spath=str(sdir), device="cpu")


def test_package_imports_no_jax():
    code = ("import sys, plate_inverse_problem_tpu_torch, "
            "plate_inverse_problem_tpu_torch.optimize, "
            "plate_inverse_problem_tpu_torch.ops.dense, "
            "plate_inverse_problem_tpu_torch.io.report, "
            "plate_inverse_problem_tpu_torch.models.materials, "
            "plate_inverse_problem_tpu_torch.fem.assembly, "
            "plate_inverse_problem_tpu_torch.oracle, "
            "plate_inverse_problem_tpu_torch.ops.csr_kernel, "
            "plate_inverse_problem_tpu_torch.mesh.edp, "
            "plate_inverse_problem_tpu_torch.io.compress, "
            "plate_inverse_problem_tpu_torch.compat, "
            "plate_inverse_problem_tpu_torch.diagnostics, "
            "plate_inverse_problem_tpu_torch.diagnostics.parity, "
            "plate_inverse_problem_tpu_torch.diagnostics.checks, "
            "plate_inverse_problem_tpu_torch.diagnostics.profile, "
            "plate_inverse_problem_tpu_torch.diagnostics.ritz, "
            "plate_inverse_problem_tpu_torch.io.checkpoint, "
            "plate_inverse_problem_tpu_torch.mesh.adapt, "
            "plate_inverse_problem_tpu_torch.utils, "
            "plate_inverse_problem_tpu_torch.parallel.ranks, "
            "plate_inverse_problem_tpu_torch.parallel.__main__; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root)
    assert res.returncode == 0, res.stderr
