"""The port's scale policies (plate_inverse_problem_tpu_torch): the adjoint
r + J's tangent pass by blocks of frequencies, the sweep's chunk and the
refined host meshes of the 46k / 104k tiers, held against the one-block
Jacobian and the JAX package on the CPU.

The plate is the JAX suite's ``symm`` ny = 1 strip (isotropic steel, the
AP1030 accelerometer, n = 420), 9 frequencies over 40-300 Hz (through the
~150 Hz resonance), theta_0 = truth x (1.05, 1.02, 1.2); the port runs on
the JAX mixed engine's operator data (``opdata_from_jax``).  The module's
one JAX Jacobian is tests/test_torch_fwd.py's, the 'complex' r + J of
``value_and_jac`` at theta_0 on the same plate, frequencies and reference
(so the persistent compilation cache serves one of the two modules): the
log_afc r and J follow from it in numpy (d|fr| = Re(conj(fr) dfr) /
|fr|).  Tolerances:

* blocked against one block: the same bits (row i of J reads only
  frequency i's solution, adjoint and residual map; K3 and ``_row_sums``
  sum each lane and row in one order whatever the lanes beside it);
* port against JAX: r and J to 1e-7 of their max |entry|
  (tests/test_torch_fwd.py's bound on this plate);
* the chunk policies: the JAX formula's sweep chunk exactly, and the
  adjoint block's bytes within its budget at the 104k tier's sizes.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.models import problem as pm
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREQS = np.linspace(40.0, 300.0, 9)
START = np.array([1.05, 1.02, 1.2])
# the 104k tier (sh_i refine = 9) and the 46k one (refine = 6): the JAX
# package's n_free and pattern entries (SCALE.md), OrthotropicD4's 8
# parameters, 512 points, an 80 GB card's Jacobian budget
N_104K, NNZ_104K = 103680, 2571222
N_46K, NNZ_46K = 46432, 1146820


def _parts(mod):
    acc = mod.Accelerometer("AP1030")
    geom = mod.Geometry("symm", acc,
                        mod.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                        ny=1)
    mat = mod.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    return geom, mat, acc


@pytest.fixture(scope="module")
def plate():
    """The port's Problem on the JAX operator data, the reference FRF at
    the truth, theta_0, the JAX log_afc r + J there (from its 'complex'
    ``value_and_jac``) and the port's adjoint log_afc r + J in one
    block."""
    pj = pip.Problem(*_parts(pip), engine="mixed")
    truth = np.asarray(pj.parameters)
    ref = np.array(pj.getFRFunction()(FREQS, truth)).astype(complex)
    th0 = truth * START
    rf = pj.getResidualFunction(FREQS, ref, kind="complex")
    r, J = (np.asarray(a) for a in rf.value_and_jac(th0))
    F = FREQS.size
    fr = (r[:F] + ref.real) + 1j * (r[F:] + ref.imag)
    mag = np.abs(fr)
    dmag = (np.conj(fr)[:, None] * (J[:F] + 1j * J[F:])).real / mag[:, None]
    rj = (np.log(mag) - np.log(np.abs(ref)), dmag / mag[:, None])
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    pp = pt.Problem(*_parts(pt), device="cpu",
                    opdata=pt.opdata_from_jax(od, "cpu"))
    rf_p = pp.getResidualFunction(FREQS, ref, kind="log_afc",
                                  jac_mode="adjoint")
    one = tuple(a.numpy() for a in rf_p.value_and_jac(th0))
    assert rf_p.blocks == (F, 1)
    return pp, ref, th0, rj, one


@pytest.mark.parametrize("per_block", [1, 3])
def test_blocked_adjoint_jacobian_has_the_one_block_bits(plate, monkeypatch,
                                                         per_block):
    pp, ref, th0, _, (r1, J1) = plate
    held = pm._ADJ_HELD_VECS * pp.n_free * 8.0 * th0.size
    monkeypatch.setattr(pm, "_jac_budget", lambda dev: per_block * held)
    rf = pp.getResidualFunction(FREQS, ref, kind="log_afc",
                                jac_mode="adjoint")
    r, J = (a.numpy() for a in rf.value_and_jac(th0))
    assert rf.blocks == (per_block, -(-FREQS.size // per_block))
    np.testing.assert_array_equal(r, r1)
    np.testing.assert_array_equal(J, J1)


def test_adjoint_jacobian_matches_jax(plate):
    _, _, _, (rj, Jj), (r, J) = plate
    assert r.shape == rj.shape and J.shape == Jj.shape
    assert np.abs(r - rj).max() <= 1e-7 * np.abs(rj).max()
    assert np.abs(J - Jj).max() <= 1e-7 * np.abs(Jj).max()


def test_row_sums_fixed_order():
    """``_row_sums`` is a sum, and a row's bits do not depend on the rows
    beside it (odd and power-of-two widths)."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 9, N_46K // 8 + 1)))
    full = pm._row_sums(x)
    np.testing.assert_allclose(full.numpy(), x.sum(-1).numpy(), rtol=0,
                               atol=1e-12)
    for sl in (slice(0, 1), slice(2, 5), slice(8, 9)):
        assert torch.equal(pm._row_sums(x[:, sl]), full[:, sl])
    assert torch.equal(pm._row_sums(x[..., :1024])[:, 3],
                       pm._row_sums(x[:, 3, :1024]))


def test_sweep_chunk_at_scale_is_the_jax_formula():
    """The 46k and 104k tiers' sweep chunks (and None below 300k pattern
    entries) are the JAX package's ``_auto_freq_chunk``."""
    for n, nnz, want in ((N_104K, NNZ_104K, 32), (N_46K, NNZ_46K, 64),
                         (20916, 513552, 64), (11910, 290688, None)):
        fake = SimpleNamespace(freq_chunk=None, n_refine=16, n_free=n,
                               device=torch.device("cpu"),
                               op=SimpleNamespace(
                                   pattern=SimpleNamespace(nnz=nnz)))
        assert pm._sweep_chunk(n, nnz, 16) == want
        assert pt.Problem._auto_freq_chunk(fake) == want
        assert pip.Problem._auto_freq_chunk(fake) == want


def test_adjoint_block_fits_its_budget_at_104k():
    """OrthotropicD4 (p = 8) at 103,680 DOF and 512 points on an 80 GB
    card: the block's tangents fit a quarter of the card, one more
    frequency would not, and the blocks cover the 512 points."""
    budget = 80e9 / 4.0
    held = pm._ADJ_HELD_VECS * N_104K * 8.0 * 8
    blk = pm._adjoint_block(N_104K, 8, 512, budget)
    assert blk * held <= budget < (blk + 1) * held
    assert 1 <= blk < 512 and -(-512 // blk) * blk >= 512
    assert pm._adjoint_block(420, 3, 7, budget) == 7
    assert pm._adjoint_block(N_104K, 8, 512, 1.0) == 1


def test_refine6_host_mesh_is_the_jax_mesh():
    """The 46k tier's copied host mesh (sh_i refine = 6) is the JAX
    package's, node for node and triangle for triangle."""
    meshes = []
    for mod in (pip, pt):
        acc = mod.Accelerometer("AP1030")
        geom = mod.Geometry("sh_i", acc, mod.GeometryParams(
            100e-3, 20e-3, 2e-3, None, None), refine=6.0)
        meshes.append(geom.get_mesh())
    a, b = meshes
    np.testing.assert_array_equal(a.nodes, b.nodes)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    np.testing.assert_array_equal(a.node_labels, b.node_labels)


def test_twogrid_coarse_inverse_is_f64():
    """The two-grid's coarse inverse stays f64 (the bench plate's band
    two-grid, n_c = 470): its f32 copy is already 3.5e-2 off here and O(1)
    off at the 46k / 104k tiers (1.3 / 2.7), where the cycle stalled and
    the 103680-DOF sweep missed its target in every lane."""
    acc = pt.Accelerometer("AP1030")
    p = pt.Problem(pt.Geometry("sh_i", acc, pt.GeometryParams(
        100e-3, 20e-3, 2e-3, None, None), refine=1.0),
        pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003),
        acc, device="cpu", precond="mg", operator_layout="band")
    kc_inv = p.getFRCore()[1]["mg_Kcinv"]
    assert kc_inv.dtype == torch.float64
    eye = np.eye(kc_inv.shape[0])
    X = kc_inv.numpy()
    assert np.abs(p._mg_Kc @ X - eye).max() <= 1e-8
    X32 = X.astype(np.float32).astype(np.float64)
    assert np.abs(p._mg_Kc @ X32 - eye).max() >= 1e-2
    assert set(p._build_s) >= {"assembly", "layout", "coarse_level",
                               "coarse_inverse", "k1_pack", "k3_plan",
                               "basis"}
