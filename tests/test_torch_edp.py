"""The ``.edp`` / ``.msh`` geometry import of the port (host copies of the
JAX package's ``mesh/edp.py``, ``mesh/delaunay.py``, ``mesh/io.py`` and
the file branch of ``models/geometry.py``) and the JAX package's golden
FRF sums through the port, on the CPU.

* The copies give the originals' outputs bit for bit: the mesh of
  ``examples/edp_import.py``'s plate with a hole (nodes, triangles,
  labels), its coarsened re-mesh, a jittered realization, the parsed
  parameters, borders, buildmesh calls and ``on(...)`` labels, and the
  ``.msh`` / ``.vtu`` files (``save_msh`` / ``load_msh`` round trips in
  both directions).
* A ``Geometry`` from the script reads the clamped label 2 and the
  xtest/ytest readout point; a setup folder naming the script (``edp``)
  or a mesh file (``msh``) loads into a ``Problem``.
* The plate's 121-point FRF (pure bending, clamped on label 2) against the
  JAX package's CPU sweep of the same plate (its default CPU engine) to
  1e-6 relative.
* The three golden sums of tests/test_golden.py (the ``symm`` ny = 2
  plate: 3-field, pure bending, perturbed) through the port within the
  1e-6 gate; each deviation is printed (pytest -s).
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.mesh import edp as jedp
from plate_inverse_problem_tpu.mesh import io as jio
from plate_inverse_problem_tpu.mesh.delaunay import build_mesh as jbuild
from plate_inverse_problem_tpu.models.geometry import \
    _parse_edp_params as jparams
from plate_inverse_problem_tpu_torch.mesh import edp as tedp
from plate_inverse_problem_tpu_torch.mesh import io as tio
from plate_inverse_problem_tpu_torch.mesh.delaunay import build_mesh as tbuild
from plate_inverse_problem_tpu_torch.models.geometry import \
    _parse_edp_params as tparams
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
from edp_import import SCRIPT  # noqa: E402  (the example's script text)

FREQS = np.linspace(60.0, 900.0, 121)      # examples/edp_import.py
GOLDEN = {"unsymm": 131.8992839383, "symm": 170.4095050154,
          "perturbed": 98.7091285291}        # tests/test_golden.py:15-17


def _same_mesh(a, b):
    for k in ("nodes", "triangles", "node_labels", "edge_labels", "edges"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    path = tmp_path_factory.mktemp("edp") / "plate_with_hole.edp"
    path.write_text(SCRIPT)
    return str(path)


def test_edp_mesh_and_parsers_match_jax():
    _same_mesh(tedp.mesh_from_edp(SCRIPT), jedp.mesh_from_edp(SCRIPT))
    _same_mesh(tedp.mesh_from_edp(SCRIPT, density_scale=0.5),
               jedp.mesh_from_edp(SCRIPT, density_scale=0.5))
    _same_mesh(tedp.mesh_from_edp(SCRIPT, seed=3, jitter=0.3),
               jedp.mesh_from_edp(SCRIPT, seed=3, jitter=0.3))
    assert tedp.parse_edp_geometry(SCRIPT) == jedp.parse_edp_geometry(SCRIPT)
    assert tedp.parse_dirichlet_labels(SCRIPT) == (2,)
    assert (tedp.parse_dirichlet_labels(SCRIPT)
            == jedp.parse_dirichlet_labels(SCRIPT))
    assert tparams(SCRIPT) == jparams(SCRIPT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert (tedp.warn_ignored_fe_statements(SCRIPT)
                == jedp.warn_ignored_fe_statements(SCRIPT) == ["problem"])


def test_build_mesh_matches_jax():
    """The Delaunay mesher on an L-shaped loop with a labelled edge, at a
    set spacing and with smoothing off."""
    t = np.linspace(0.0, 1.0, 9)[:-1]
    pts = np.concatenate([np.c_[2 * t, 0 * t], np.c_[2 + 0 * t, t],
                          np.c_[2 - t, 1 + 0 * t], np.c_[1 + 0 * t, 1 + t],
                          np.c_[1 - t, 2 + 0 * t], np.c_[0 * t, 2 - 2 * t]])
    labels = np.repeat([1, 2, 0, 0, 0, 3], t.size)
    for kw in ({}, {"h": 0.15, "smooth": 0}):
        _same_mesh(tbuild([(pts, labels)], **kw), jbuild([(pts, labels)],
                                                         **kw))


def test_msh_and_vtu_files_match_jax(tmp_path):
    mesh = tedp.mesh_from_edp(SCRIPT)
    tio.save_msh(mesh, tmp_path / "t.msh")
    jio.save_msh(jedp.mesh_from_edp(SCRIPT), tmp_path / "j.msh")
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh"
                                                 ).read_bytes()
    _same_mesh(tio.load_msh(str(tmp_path / "j.msh")),
               jio.load_msh(str(tmp_path / "t.msh")))
    back = tio.load_msh(str(tmp_path / "t.msh"))
    np.testing.assert_allclose(back.nodes, mesh.nodes, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)
    np.testing.assert_array_equal(back.boundary_edges(),
                                  mesh.boundary_edges())
    tio.save_vtu(mesh, tmp_path / "t.vtu", {"w": mesh.nodes[:, 0]})
    jio.save_vtu(mesh, tmp_path / "j.vtu", {"w": mesh.nodes[:, 0]})
    assert (tmp_path / "t.vtu").read_bytes() == (tmp_path / "j.vtu"
                                                 ).read_bytes()


def test_geometry_and_setup_folders(script, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        gt = pt.Geometry(script, height=2e-3)
        gj = pip.Geometry(script, height=2e-3)
    assert gt.clamped_labels == gj.clamped_labels == (2,)
    assert gt.test_point == gj.test_point == (25e-3, 5e-3)
    _same_mesh(gt.get_mesh(), gj.get_mesh())
    _same_mesh(gt.coarsened(2.0).get_mesh(), gj.coarsened(2.0).get_mesh())
    # setup folders: the script by name (relative to the folder) and its
    # mesh as a .msh file (absolute), with the plate's size and an
    # accelerometer position for the 3-field path
    mat = {"density": 7920.0, "atype": "isotropic", "E": 200e9, "G": 75e9,
           "beta": 0.003}
    for key in ("edp", "msh"):
        folder = tmp_path / key
        folder.mkdir()
        if key == "edp":
            (folder / "plate.edp").write_text(SCRIPT)
            fname = "plate.edp"
        else:
            fname = str(tmp_path / "plate.msh")
            tio.save_msh(gt.get_mesh(), fname)
        (folder / "setup.json").write_text(json.dumps({
            "accelerometer": "AP1030", "material": mat,
            "geometry": {key: fname, "length": 90e-3, "width": 30e-3,
                         "height": 2e-3, "accel_x": 15e-3,
                         "accel_y": 15e-3}}))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            p = pt.Problem(spath=str(folder), device="cpu")
            q = pip.Problem(spath=str(folder))
        assert p.geometry.can_coarsen == (key == "edp")
        assert p.geometry.clamped_labels == q.geometry.clamped_labels
        assert (p.n_free, p.op.pattern.nnz) == (q.n_free, q.op.pattern.nnz)
        np.testing.assert_array_equal(p.mesh.triangles, q.mesh.triangles)


def test_edp_plate_frf_matches_jax(script):
    mat = dict(E=200e9, G=75e9, beta=0.003)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pj = pip.Problem(pip.Geometry(script, height=2e-3),
                         pip.get_material(7920.0, "isotropic", **mat), None)
        pp = pt.Problem(pt.Geometry(script, height=2e-3),
                        pt.get_material(7920.0, "isotropic", **mat), None,
                        device="cpu")
        yj = np.asarray(pj.solveForward(FREQS))
        yt = pp.solveForward(FREQS).numpy()
    assert pp.is_symmetric_path and pp.n_free == pj.n_free
    assert np.all(np.abs(yt - yj) <= 1e-6 * np.abs(yj))


@pytest.mark.parametrize("case", list(GOLDEN))
def test_golden_sums_through_port(case):
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                       ny=2)
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    p = pt.Problem(geom, mat, None if case == "symm" else acc, device="cpu")
    params = np.asarray(p.parameters)
    if case == "perturbed":
        params = params * np.array([1.1, 1.1, 1.2])
    total = np.abs(p.solveForward(np.linspace(40, 600, 50), params).numpy()
                   ).sum()
    dev = abs(total - GOLDEN[case]) / GOLDEN[case]
    print(f"golden {case}: port {total!r} vs {GOLDEN[case]!r}, rel {dev:.2e}")
    assert dev <= 1e-6
