"""The port's two-grid preconditioner (plate_inverse_problem_tpu_torch/ops/
mg.py) held against the JAX package on the CPU, on the operator data of the
small band + two-grid plate (n = 1466, b = 256, nb = 6, n_c = 470) handed to
the port through ``opdata_from_jax``.

Tolerances: the host-side code is a copy and must agree exactly; the f32
cycle agrees to 1e-5 relative, because the f32 sums (band, prolongation and
coarse-inverse GEMMs) are taken in another order on the two sides.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops import mg as jmg
from plate_inverse_problem_tpu_torch.ops import mg as tmg
from plate_inverse_problem_tpu_torch.ops.band_kernel import (
    band_mv_f32, pack_band_tiles)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)


@pytest.fixture(scope="module")
def pair():
    """(JAX Problem, its numpy opdata, port Problem on that opdata)."""
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pip.Geometry("sh_i", acc, pip.GeometryParams(*GP), refine=1.0)
    pj = pip.Problem(geom, mat, acc, engine="mixed", precond="mg",
                     operator_layout="band")
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    acc_t = pt.Accelerometer("AP1030")
    mat_t = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom_t = pt.Geometry("sh_i", acc_t, pt.GeometryParams(*GP), refine=1.0)
    pp = pt.Problem(geom_t, mat_t, acc_t, device="cpu", precond="mg",
                    operator_layout="band",
                    opdata=pt.opdata_from_jax(od, "cpu"))
    pp.getFRCore()
    return pj, od, pp


def test_two_grid_statics_match_jax(pair):
    pj, _, pp = pair
    assert (pp.n_free, pp._mg_rl.n_coarse) == (1466, 470)
    assert pp._mg_lmax == pj._mg_lmax
    for f in ("n_fine", "n_coarse", "nb", "b", "bc", "nd", "hw", "perm_c",
              "slots", "lin", "vals"):
        np.testing.assert_array_equal(getattr(pp._mg_rl, f),
                                      getattr(pj._mg_rl, f))
    assert (pp._mg_Kc != pj._mg_Kc).nnz == 0


def test_prolongation_matches_jax(pair):
    pj, _, pp = pair
    cj = pj.geometry.coarsened(2.0)
    ct = pp.geometry.coarsened(2.0)
    cpj = pip.Problem(cj, pj.material, pj.accelerometer, engine="direct")
    mesh_c, free_c, cons_c = pp._coarse_level(2.0)
    np.testing.assert_array_equal(mesh_c.nodes, cpj.mesh.nodes)
    np.testing.assert_array_equal(free_c, cpj.op.free_idx)
    Pj = jmg.build_prolongation(pj.mesh, cpj.mesh, pj.op.free_idx,
                                cpj.op.free_idx, pj.op.constrained,
                                cpj.op.constrained, three_field=True)
    Pt = tmg.build_prolongation(pp.mesh, mesh_c, pp.op.free_idx, free_c,
                                pp.op.constrained, cons_c, three_field=True)
    assert ct.get_mesh().num_nodes == mesh_c.num_nodes
    assert (Pj != Pt).nnz == 0


@pytest.mark.parametrize("shape", [(2, 4), (3,)])
def test_twogrid_apply_matches_jax(pair, shape):
    pj, od, pp = pair
    n = pp.n_free
    rng = np.random.default_rng(sum(shape))
    r = rng.standard_normal(shape + (n,)).astype(np.float32)
    y_j = np.asarray(jmg.twogrid_apply(
        jnp.asarray(od["mg_band0"]), jnp.asarray(od["mg_dinv"]), pj._mg_lmax,
        jnp.asarray(od["mg_Pt"]), jnp.asarray(od["mg_Kcinv"]),
        jnp.asarray(r), pj._band_layout, pj._mg_rl,
        jnp.asarray(od["mg_slots"])))
    t = pt.opdata_from_jax(od, "cpu")
    pack = pack_band_tiles(t["mg_band0"], pp._band_layout)
    y_t = tmg.twogrid_apply(
        pack, t["mg_dinv"], pp._mg_lmax, t["mg_Pt"], t["mg_Kcinv"],
        torch.from_numpy(r), pp._band_layout, pp._mg_rl, t["mg_slots"])
    assert y_t.dtype == torch.float32 and y_t.shape == r.shape
    y_t = y_t.numpy()
    assert np.abs(y_t - y_j).max() / np.abs(y_j).max() <= 1e-5


def test_chebyshev_smooth_matches_jax(pair):
    pj, od, pp = pair
    n = pp.n_free
    rng = np.random.default_rng(9)
    r = rng.standard_normal((4, n)).astype(np.float32)
    e0 = rng.standard_normal((4, n)).astype(np.float32)
    band_j = jnp.asarray(od["mg_band0"])
    t = pt.opdata_from_jax(od, "cpu")
    from plate_inverse_problem_tpu.ops.band import band_mv as jbmv
    sm_j = {"dinv": jnp.asarray(od["mg_dinv"]), "lmax": pj._mg_lmax}
    sm_t = {"dinv": t["mg_dinv"], "lmax": pp._mg_lmax}
    pack = pack_band_tiles(t["mg_band0"], pp._band_layout)
    for e in (None, e0):
        y_j = np.asarray(jmg._chebyshev_smooth(
            sm_j, lambda x: jbmv(band_j, x, pj._band_layout),
            jnp.asarray(r), e0=None if e is None else jnp.asarray(e)))
        y_t = tmg._chebyshev_smooth(
            sm_t, lambda x: band_mv_f32(pack, x, pp._band_layout),
            torch.from_numpy(r),
            e0=None if e is None else torch.from_numpy(e)).numpy()
        assert np.abs(y_t - y_j).max() / np.abs(y_j).max() <= 1e-5


def test_dinv_lmax_and_pin_dead_match_jax(pair):
    import scipy.sparse as sp

    pj, _, _ = pair
    K = pj._mg_Kc
    dj, lj = jmg._dinv_lmax(K)
    dt, lt = tmg._dinv_lmax(K)
    np.testing.assert_array_equal(dt, dj)
    assert lt == lj
    P = sp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 1.0]]))
    Kc = sp.csc_matrix(np.arange(9.0).reshape(3, 3) + 1.0)
    assert (jmg._pin_dead(Kc, P) != tmg._pin_dead(Kc, P)).nnz == 0
