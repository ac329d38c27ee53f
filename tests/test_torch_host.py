"""The port's host modules held against the JAX package's on the CPU:
``io/checkpoint.py``, ``mesh/adapt.py`` (with the ``TriangleMesh``
helpers it needs), ``utils/timers.py``, ``utils/plotting.py`` and the
JAX ``Geometry`` keywords ``mesh=`` / ``export_vtk=``.

* a checkpoint written by either package loads in the other with the
  same bits, and ``checkpointed_optimize`` resumes (JAX
  tests/test_aux.py's case, on the port's optimizer);
* ``adapted_mesh`` (a copy over the port's Delaunay mesher) gives the JAX
  function's nodes and triangles bit for bit and meets the JAX test's
  assertions (tests/test_delaunay.py:244); an adapted mesh goes back into
  a ``Problem`` through ``Geometry(mesh=..., height=...)``, whose sweep
  meets the refined splu to 1e-6;
* the timers synchronise and time; the plotting helpers (matplotlib's Agg
  backend) draw a tensor's FRF with the JAX helpers' panel data.
"""
import os

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.io import checkpoint as jck
from plate_inverse_problem_tpu.mesh import adapt as jadapt
from plate_inverse_problem_tpu.mesh.delaunay import border as jborder
from plate_inverse_problem_tpu.mesh.delaunay import chain as jchain
from plate_inverse_problem_tpu.utils import plotting as jplot
from plate_inverse_problem_tpu_torch.io import checkpoint as tck
from plate_inverse_problem_tpu_torch.mesh import adapt as tadapt
from plate_inverse_problem_tpu_torch.mesh.delaunay import border, chain
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from plate_inverse_problem_tpu_torch.utils import plotting, timers
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

LX, LY, X0, W = 100e-3, 20e-3, 30e-3, 6e-3


def _loop(border, chain):
    """The JAX test's strip, clamped (label 1) on its right border."""
    return chain(
        border(lambda t: (0 * t, LY / 2 - t * LY), 0, 1, 10),
        border(lambda t: (LX * t, -LY / 2 + 0 * t), 0, 1, 50),
        border(lambda t: (LX + 0 * t, -LY / 2 + t * LY), 0, 1, 10, label=1),
        border(lambda t: ((1 - t) * LX, LY / 2 + 0 * t), 0, 1, 50))


@pytest.fixture(scope="module")
def adapted():
    """(port mesh, JAX mesh, port start mesh, u): one adapt cycle of the
    JAX test in each package."""
    out = []
    for mod, bd, ch in ((tadapt, border, chain),
                        (jadapt, jborder, jchain)):
        loop = _loop(bd, ch)
        m0 = mod.build_mesh([loop], smooth=3)
        u = np.exp(-((m0.nodes[:, 0] - X0) ** 2 + m0.nodes[:, 1] ** 2)
                   / W ** 2)
        out.append((mod.adapted_mesh([loop], m0, u, rel_err=0.01), m0, u))
    return out


def test_checkpoint_loads_across_packages(tmp_path):
    """npz + json sidecar: the port's file in the JAX loader and the JAX
    package's in the port's, the same arrays, scalars and lists."""
    st = {"x": np.array([1.0, 2.0]), "done": 7, "status": "Running",
          "f_history": np.array([3.0, 2.5]),
          "x_history": [np.zeros(2), np.ones(2)]}
    for save, load in ((tck.save_checkpoint, jck.load_checkpoint),
                       (jck.save_checkpoint, tck.load_checkpoint)):
        path = save(str(tmp_path / f"ck_{save.__module__}"), st)
        got = load(path)
        assert got["done"] == 7 and got["status"] == "Running"
        np.testing.assert_array_equal(got["x"], st["x"])
        np.testing.assert_array_equal(got["f_history"], st["f_history"])
        assert len(got["x_history"]) == 2
        np.testing.assert_array_equal(got["x_history"][1], np.ones(2))


def test_checkpointed_optimize_resumes(tmp_path):
    """JAX tests/test_aux.py's resume case on the port's gradient descent
    and a torch loss: 6 steps in chunks of 3, then resumed to 12."""
    m = torch.tensor([0.7, -1.3], dtype=torch.float64)

    def quad(x):
        d = x - m
        return 0.5 * d @ d

    ck = str(tmp_path / "opt_ck")
    r1 = tck.checkpointed_optimize(pt.optimize_gd, quad, torch.zeros(2),
                                   checkpoint_path=ck, checkpoint_every=3,
                                   N_steps=6, h=0.3)
    assert r1.niter == 6
    r2 = tck.checkpointed_optimize(pt.optimize_gd, quad, torch.zeros(2),
                                   checkpoint_path=ck, checkpoint_every=3,
                                   N_steps=12, h=0.3)
    assert r2.niter == 12
    assert len(r2.f_history) >= len(r1.f_history)
    np.testing.assert_allclose(np.asarray(r2.x), m.numpy(), atol=5e-2)
    assert jck.load_checkpoint(ck)["done"] == 12


def test_adapted_mesh_equals_jax(adapted):
    """The adapted mesh, bit for bit, and the JAX test's assertions:
    refined at the feature, coarser far away."""
    (m1, m0, u), (j1, j0, ju) = adapted
    np.testing.assert_array_equal(m0.nodes, j0.nodes)
    np.testing.assert_array_equal(m1.nodes, j1.nodes)
    np.testing.assert_array_equal(m1.triangles, j1.triangles)
    np.testing.assert_array_equal(m1.edge_lengths(), j1.edge_lengths())
    np.testing.assert_array_equal(m1.areas(), j1.areas())
    el = m1.edge_lengths()
    mid = 0.5 * (m1.nodes[m1.edges[:, 0]] + m1.nodes[m1.edges[:, 1]])
    near = el[np.hypot(mid[:, 0] - X0, mid[:, 1]) < W].mean()
    far = el[mid[:, 0] > 70e-3].mean()
    assert far / near > 1.5, (near, far)
    el0 = m0.edge_lengths()
    mid0 = 0.5 * (m0.nodes[m0.edges[:, 0]] + m0.nodes[m0.edges[:, 1]])
    assert near < el0[np.hypot(mid0[:, 0] - X0, mid0[:, 1]) < W].mean()
    # the size field itself, at the start mesh's nodes
    q = m0.nodes[::7]
    np.testing.assert_array_equal(
        tadapt.size_field_from_values(m0, u, 0.01)(q),
        jadapt.size_field_from_values(j0, ju, 0.01)(q))


def test_adapted_mesh_into_a_problem(adapted):
    """``Geometry(mesh=..., height=...)`` takes the adapted mesh: the
    pure-bending plate clamped on label 1, read at a given test point via
    ``params``, meets the refined splu at the peak and off it; without a
    height it raises, as in the JAX package."""
    m1 = adapted[0][0]
    with pytest.raises(ValueError, match="Height"):
        pt.Geometry(mesh=m1)
    geom = pt.Geometry(mesh=m1, params=pt.GeometryParams(
        None, None, 2e-3, 20e-3, 0.0))
    assert geom.get_mesh() is m1 and geom.height == 2e-3
    assert not geom.can_coarsen
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    p = pt.Problem(geom, mat, None, device="cpu")
    freqs = np.linspace(60.0, 600.0, 28)
    fr = p.solveForward(freqs).numpy()
    idx = [2, int(np.argmax(np.abs(fr))), 20]
    ref = splu_frf(p, freqs[idx])
    assert np.all(np.abs(fr[idx] - ref) <= 1e-6 * np.abs(ref))
    geom_h = pt.Geometry(mesh=m1, height=2e-3)
    assert geom_h.height == 2e-3 and geom_h.template is None


def test_geometry_export_vtk():
    """``export_vtk=True`` writes the mesh to ``geometry/export.vtu`` in
    the port's package when it is built (JAX tests/test_mesh.py:88), once."""
    from plate_inverse_problem_tpu_torch.utils.paths import get_package_dir

    out = os.path.join(get_package_dir(), "geometry", "export.vtu")
    if os.path.exists(out):
        os.remove(out)
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc, pt.GeometryParams(100e-3, 20e-3, 2e-3,
                                                      10e-3, None),
                       ny=1, export_vtk=True)
    assert not os.path.exists(out)
    m = geom.get_mesh()
    assert os.path.exists(out)
    txt = open(out).read()
    assert f'NumberOfPoints="{m.num_nodes}"' in txt
    os.remove(out)
    geom.get_mesh()
    assert not os.path.exists(out)


def test_timers():
    """``Timer`` stores its seconds under its label; ``block_and_time``
    returns the result, the first call's and the steady seconds (on the
    CPU there is nothing to synchronise)."""
    res = {}
    with timers.Timer("a", res):
        sum(range(1000))
    assert res["a"] >= 0.0
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": (x * 2, [x + 1])}

    out, first_s, per_call = timers.block_and_time(fn, torch.ones(4),
                                                   warmup=2, iters=3)
    assert len(calls) == 1 + 1 + 3
    assert torch.equal(out["y"][0], torch.full((4,), 2.0))
    assert first_s >= 0.0 and per_call >= 0.0
    assert timers._cuda_devices(out) == set()


def test_plotting_draws_tensors(tmp_path):
    """``plot_fr`` (Radial, then overlaid) and ``plot_fr_complex`` on a
    complex FRF tensor, with the JAX helpers' panel values;
    ``png_matrix`` writes a png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(3)
    freqs = np.linspace(40.0, 600.0, 30)
    fr = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    for mode in ("Radial", "Complex"):
        for a, b in zip(plotting._panels(torch.as_tensor(freqs),
                                         torch.as_tensor(fr), mode),
                        jplot._panels(freqs, fr, mode)):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
    fig, axs = plotting.plot_fr(torch.as_tensor(freqs), torch.as_tensor(fr),
                                label="a")
    fig, axs = plotting.plot_fr(freqs, fr * 2, fig=fig, label="b")
    assert axs[0].get_yscale() == "log" and len(axs[0].lines) == 2
    fig2, axs2 = plt.subplots(1, 2)
    plotting.plot_fr_complex(freqs, torch.as_tensor(fr), fig2, axs2,
                             label="c")
    np.testing.assert_array_equal(axs2[1].lines[0].get_ydata(), fr.imag)
    path = str(tmp_path / "m.png")
    plotting.png_matrix(torch.eye(4), path)
    assert os.path.getsize(path) > 0
    plt.close("all")
