"""The port's frequency sharding over torch.distributed
(plate_inverse_problem_tpu_torch/parallel) held against the single-process
port and the JAX package on the CPU.

The plate is the JAX parallel tests' one: ``symm`` ny = 1, isotropic steel,
AP1030 (n = 420, the mixed engine's flat + dense tier, so the dense
inverse ``invK64`` exists and n is even), 13 frequencies over 40-600 Hz
(they pad to 15 over three ranks and to 14 over two), theta = truth x
(1.02, 0.99, 1.05), the reference FRF the plate's at the truth.  Two
spawns of gloo ranks on the CPU run every check at once (``parallel.
ranks.sharded_checks``, one torch thread each, twice each step) and write
their records: world 3 as a (freq 3, dof 1) mesh with every step, world 4
as a (freq 2, dof 2) mesh, its dense inverse row-partitioned.
Tolerances:

* against the single-process port: the FRF and the loss 1e-9 relative,
  the gradient 1e-8 of its max (the JAX parallel tests' bounds), the
  Gauss-Newton |r|^2 and update 1e-9 relative (the ranks' partial sums
  add in another order: 1e-12 measured); the dof mesh's FRF 1e-7 (the
  JAX dof test's bound; the column blocks of the inverse's product give
  the same bits here);
* adjoint against forward-mode Gauss-Newton: rtol 1e-5, atol 1e-12 (the
  JAX test's); one frequency per call against the whole slice: 1e-9;
* against the JAX package's single-device CPU engine (modal, an exact
  f64 solve): the FRF 1e-6 relative (the port tests' bound for the mixed
  sweep against an exact one), the loss and gradient 1e-5 relative (tests/
  test_torch_inverse.py's), the Gauss-Newton update 1e-6 relative (its
  iterates' bound);
* every rank and both runs of a step: the same bits.
"""
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.parallel import (
    Mesh, make_mesh, opdata_shardings, shard_frequencies, sharded_fr_function,
    sharded_gn_step, sharded_train_step)
from plate_inverse_problem_tpu_torch.parallel import ranks
from plate_inverse_problem_tpu_torch.parallel.freq_shard import _placed
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PLATE = {"geometry": "symm", "ny": 1}
FREQS = np.linspace(40.0, 600.0, 13)
THETA = (1.02, 0.99, 1.05)
GN_STEPS = ("gn_adjoint", "gn_fwd", "gn_chunk")


def _spawn(tmp_path_factory, world, shape, steps):
    out = str(tmp_path_factory.mktemp(f"world{world}"))
    spec = {"plate": PLATE, "meshes": [shape],
            "freqs": (FREQS[0], FREQS[-1], FREQS.size), "theta": THETA,
            "repeats": 2, "steps": steps}
    with pytest.MonkeyPatch.context() as mp:
        # one BLAS / OpenMP thread in each rank (the host's other workers)
        mp.setenv("OPENBLAS_NUM_THREADS", "1")
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks.spawn(ranks.sharded_checks, world, out, spec, device="cpu")
    return ranks.load(out, world)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _spawn(tmp_path_factory, 3, (3, 1), ("train",) + GN_STEPS)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory, 4, (2, 2), ("train", "gn_adjoint"))


@pytest.fixture(scope="module")
def single(world3):
    """The single-process port at the ranks' reference and theta: the FRF,
    the MSE_LOG_AFC value and gradient, and per Jacobian mode (r, J) with
    the host normal equations' update."""
    p = ranks.plate_problem(PLATE, "cpu")
    rec = world3[0]
    ref, th0 = rec["ref"], rec["theta"]
    v, g = p.getLossFunction(FREQS, ref, "MSE_LOG_AFC").value_and_grad(th0)
    out = {"p": p, "ref": ref, "theta": th0,
           "frf": p.solveForward(FREQS, rec["truth"]).numpy(),
           "loss": (float(v), g.numpy())}
    for mode in ("adjoint", "fwd"):
        rf = p.getResidualFunction(FREQS, ref, kind="log_afc",
                                   jac_mode=mode)
        r, J = (a.numpy() for a in rf.value_and_jac(th0))
        out[mode] = (r, J, th0 + np.linalg.solve(J.T @ J, -(J.T @ r)))
    return out


@pytest.fixture(scope="module")
def jax_ref(single):
    """The JAX package on one CPU device, its default engine there (modal):
    the FRF at the truth, the MSE_LOG_AFC value and gradient and the
    forward-mode (r, J) at the ranks' reference and theta."""
    import jax.numpy as jnp

    import plate_inverse_problem_tpu as pip

    acc = pip.Accelerometer("AP1030")
    geom = pip.Geometry("symm", acc,
                        pip.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                        ny=1)
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    pj = pip.Problem(geom, mat, acc)
    th0 = jnp.asarray(single["theta"])
    v, g = pj.getLossFunction(FREQS, single["ref"],
                              "MSE_LOG_AFC").value_and_grad(th0)
    r, J = pj.getResidualFunction(FREQS, single["ref"], kind="log_afc",
                                  jac_mode="fwd").value_and_jac(th0)
    return {"frf": np.asarray(pj.solveForward(FREQS)), "loss": float(v),
            "grad": np.asarray(g), "r": np.asarray(r), "J": np.asarray(J)}


def _mesh(recs):
    return [r["meshes"][0] for r in recs]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) / np.asarray(b) - 1.0)))


def _rel_max(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def test_mesh_layout_and_padding(world3, world4):
    """Rank = i_freq * dof + i_dof; the frequencies pad to a multiple of
    the freq axis by repeating the last one; without a process group the
    mesh is a world of one; a world that does not split raises."""
    for recs, (nf, nd) in ((world3, (3, 1)), (world4, (2, 2))):
        for rank, m in enumerate(_mesh(recs)):
            assert m["shape"] == (nf, nd)
            assert m["coords"] == {"freq": rank // nd, "dof": rank % nd}
            padded = m["padded"]
            assert padded.size == -(-FREQS.size // nf) * nf
            np.testing.assert_array_equal(padded[:FREQS.size], FREQS)
            assert np.all(padded[FREQS.size:] == FREQS[-1])
    mesh = make_mesh()
    assert mesh.shape == {"freq": 1, "dof": 1} and mesh.groups == {}
    fs = shard_frequencies(mesh, FREQS)
    assert torch.equal(fs.local, fs.padded)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(dof_axis=2)
    with pytest.raises(ValueError, match="one rank drives one device"):
        make_mesh(n_devices=8)


def test_sharded_frf_matches_single_process(world3, single):
    """Three ranks' FRF against the single-process sweep, 1e-9; a world of
    one without a process group gives the sweep's bits."""
    for m in _mesh(world3):
        assert _rel(m["frf"][0][:FREQS.size], single["frf"]) <= 1e-9
    p = single["p"]
    mesh = make_mesh()
    fr = sharded_fr_function(p, mesh)(shard_frequencies(mesh, FREQS),
                                      world3[0]["truth"])
    assert torch.equal(fr, torch.as_tensor(single["frf"]))


def test_train_step_matches_loss_function(world3, single):
    v, g = single["loss"]
    th0 = single["theta"]
    for m in _mesh(world3):
        loss, grad, new = m["train"][0]
        assert abs(loss - v) <= 1e-9 * v
        assert _rel_max(grad, g) <= 1e-8
        np.testing.assert_allclose(new, th0 - 1e-3 * grad, rtol=1e-15)


def test_gn_step_matches_host_normal_equations(world3, single):
    """Both Jacobian modes against the single-process ResidualFunction and
    the host normal equations; the step lowers the residual."""
    p = single["p"]
    for m in _mesh(world3):
        for name, mode in (("gn_adjoint", "adjoint"), ("gn_fwd", "fwd")):
            r, _, th1 = single[mode]
            rsq, th = m[name][0]
            assert abs(rsq - r @ r) <= 1e-9 * (r @ r)
            assert _rel(th, th1) <= 1e-9
    rf = p.getResidualFunction(FREQS, single["ref"], kind="log_afc")
    r1 = rf(_mesh(world3)[0]["gn_adjoint"][0][1]).numpy()
    r0 = single["adjoint"][0]
    assert r1 @ r1 < r0 @ r0


def test_gn_adjoint_matches_fwd(world3):
    for m in _mesh(world3):
        (rsq_a, th_a), (rsq_f, th_f) = m["gn_adjoint"][0], m["gn_fwd"][0]
        assert abs(rsq_a - rsq_f) <= 1e-9 * rsq_f
        np.testing.assert_allclose(th_a, th_f, rtol=1e-5, atol=1e-12)


def test_gn_segmented_matches_unsegmented(world3):
    """freq_chunk=1: one frequency per call on every rank, the partial sums
    added on the host."""
    for m in _mesh(world3):
        (rsq_u, th_u), (rsq_s, th_s) = m["gn_adjoint"][0], m["gn_chunk"][0]
        assert abs(rsq_s - rsq_u) <= 1e-9 * rsq_u
        assert _rel(th_s, th_u) <= 1e-9


def test_dof_mesh_partitions_inverse(world4, single):
    """On the (freq 2, dof 2) mesh each rank holds n/2 rows of invK64; the
    FRF meets the single-process sweep to 1e-7, the loss, gradient and
    Gauss-Newton update to the freq mesh's bounds."""
    n = single["p"].n_free
    v, g = single["loss"]
    for m in _mesh(world4):
        assert m["shards"] == {"invK64": (n // 2, n)}
        assert _rel(m["frf"][0][:FREQS.size], single["frf"]) <= 1e-7
        loss, grad, _ = m["train"][0]
        assert abs(loss - v) <= 1e-9 * v and _rel_max(grad, g) <= 1e-8
        assert _rel(m["gn_adjoint"][0][1], single["adjoint"][2]) <= 1e-9
        assert m["collectives"] > 8     # the dof group's products ran
    # a rank's block is a view of the Problem's inverse, placed once per
    # (Problem, mesh)
    mesh = Mesh(2, 2, 1, None, {})
    _, od = _placed(single["p"], mesh)
    full = single["p"].getFRCore()[1]["invK64"]
    assert od["invK64"].rows.data_ptr() == full[n // 2:].data_ptr()
    assert _placed(single["p"], mesh)[1] is od


def _bits(run):
    """The bytes of a step's result (an array or a tuple of them)."""
    parts = run if isinstance(run, tuple) else (run,)
    return b"".join(np.atleast_1d(np.asarray(x)).tobytes() for x in parts)


def test_bits_identical_across_ranks_and_runs(world3, world4):
    for recs in (world3, world4):
        ms = _mesh(recs)
        for key in ("frf", "train", *GN_STEPS):
            if key in ms[0]:
                runs = [_bits(run) for m in ms for run in m[key]]
                assert len(runs) == 2 * len(ms)
                assert all(b == runs[0] for b in runs), key


def test_children_use_one_thread_and_no_jax(world3, world4):
    for rec in world3 + world4:
        assert rec["jax_loaded"] == []
        assert rec["threads"] == 1


def test_matches_jax_single_device(world3, single, jax_ref):
    m = _mesh(world3)[0]
    assert _rel(m["frf"][0][:FREQS.size], jax_ref["frf"]) <= 1e-6
    loss, grad, _ = m["train"][0]
    assert abs(loss - jax_ref["loss"]) <= 1e-5 * jax_ref["loss"]
    assert np.all(np.abs(grad - jax_ref["grad"])
                  <= 1e-5 * np.abs(jax_ref["grad"]))
    r, J = jax_ref["r"], jax_ref["J"]
    th1 = single["theta"] + np.linalg.solve(J.T @ J, -(J.T @ r))
    rsq, th = m["gn_fwd"][0]
    assert abs(rsq - r @ r) <= 1e-5 * (r @ r)
    assert _rel(th, th1) <= 1e-6


def test_opdata_shardings_match_jax_specs(single):
    """The port's placement of the dense inverses against the JAX
    ``opdata_shardings`` on the conftest's 8 virtual devices as a (4, 2)
    mesh (JAX's f32 ``invK32`` is the port's f64 ``invK64``); the band
    panel W64, which JAX partitions too, the port keeps replicated."""
    from jax.sharding import PartitionSpec as P

    from plate_inverse_problem_tpu.parallel import make_mesh as jmake_mesh
    from plate_inverse_problem_tpu.parallel.freq_shard import (
        opdata_shardings as jshardings)

    od = single["p"].getFRCore()[1]
    names = {"invK64": "invK32"}
    jod = {names.get(k, k): np.zeros(v.shape, np.float32)
           for k, v in od.items()}
    jspec = jshardings(jmake_mesh(8, dof_axis=2), jod)
    spec = opdata_shardings(Mesh(4, 2, 0, None, {}), od)
    assert jspec["invK32"].spec == P("dof", None)
    assert spec["invK64"] == tuple(jspec["invK32"].spec)
    assert jspec["W64"].spec == P("dof", None) and spec["W64"] == ()
    assert all(s == () for k, s in spec.items() if k != "invK64")
    assert all(s == () for s in opdata_shardings(make_mesh(), od).values())


def test_unknown_options_raise(single):
    p = single["p"]
    mesh = make_mesh()
    with pytest.raises(ValueError, match="residual kind"):
        sharded_gn_step(p, mesh, kind="complex")
    with pytest.raises(ValueError, match="Unknown jac_mode"):
        sharded_gn_step(p, mesh, jac_mode="reverse")
    assert sharded_gn_step(p, mesh).jac_mode == "adjoint"
    modal = pt.Problem(p.geometry, p.material, p.accelerometer,
                       engine="modal", device="cpu")
    with pytest.raises(ValueError, match="adjoint hooks"):
        sharded_gn_step(modal, mesh, jac_mode="adjoint")
    assert sharded_gn_step(modal, mesh).jac_mode == "fwd"
    with pytest.raises(ValueError, match="multiple of the freq axis"):
        sharded_fr_function(p, Mesh(2, 1, 0, None, {}))(FREQS,
                                                         p.parameters)
    # a training step on the modal engine (its step runs the same code)
    loss, g, _ = sharded_train_step(modal, make_mesh())(
        FREQS, single["ref"], single["theta"])
    assert np.isfinite(float(loss)) and torch.all(torch.isfinite(g))
