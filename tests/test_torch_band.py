"""The port's band layer (plate_inverse_problem_tpu_torch/ops/band.py and the
band kernel's plain version) and flat matvec (the plain version of K3,
ops/csr_kernel.py) held against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages.  Tolerances:

* f32 band matvec (the port's on the packed band): <= 1e-6 of max |y| —
  both sides sum the 3b products of a row in f32, in different orders;
* f64 band matvec, flat_to_band and the flat COO matvec: <= 1e-14 of the
  row abs-sum — f64
  rounding of sums of up to 3b terms.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import plate_inverse_problem_tpu as pip
from plate_inverse_problem_tpu.ops import band as jband
from plate_inverse_problem_tpu.ops.pallas_band import band_mv_pallas
from plate_inverse_problem_tpu.ops.scatter import spmv_flat as jspmv_flat
from plate_inverse_problem_tpu_torch.ops import band as tband
from plate_inverse_problem_tpu_torch.ops import band_kernel
from plate_inverse_problem_tpu_torch.ops.csr_kernel import scatter_mv
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def plate_layout():
    """Pattern and band layout of the n = 1466 ``sh_i`` plate (b = 256)."""
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pip.Geometry("sh_i", acc,
                        pip.GeometryParams(100e-3, 20e-3, 2e-3, None, None))
    p = pip.Problem(geom, mat, acc)
    rows = np.asarray(p.op.pattern.rows)
    cols = np.asarray(p.op.pattern.cols)
    return rows, cols, p.n_free


def _synthetic_b64():
    """Narrow-band pattern whose RCM block size is 64 (test_band.py:203)."""
    n, w = 400, 9
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    return rows, cols, n


def _layouts(rows, cols, n, **kw):
    lj = jband.build_band_layout(rows, cols, n, **kw)
    lt = tband.build_band_layout(rows, cols, n, **kw)
    return lj, lt


def test_band_layout_matches_jax(plate_layout):
    rows, cols, n = plate_layout
    lj, lt = _layouts(rows, cols, n)
    assert (lt.n, lt.b, lt.nb, lt.bandwidth) == (lj.n, lj.b, lj.nb,
                                                 lj.bandwidth)
    assert (lt.b, lt.nb) == (256, 6)
    np.testing.assert_array_equal(lt.perm, lj.perm)
    np.testing.assert_array_equal(lt.iperm, lj.iperm)
    np.testing.assert_array_equal(lt.lin, lj.lin)
    for a, b in zip(tband.permute_pattern(lt, rows, cols),
                    jband.permute_pattern(lj, rows, cols)):
        np.testing.assert_array_equal(a, b)
    v = np.random.default_rng(0).standard_normal((3, n))
    np.testing.assert_array_equal(tband.permute_vector(lt, v),
                                  jband.permute_vector(lj, v))


@pytest.mark.parametrize("shape", [(16,), (3,), (), (2, 4)])
def test_band_mv_f32_plain_matches_jax_and_pallas(plate_layout, shape):
    """K1's plain version, on the packed band, against JAX band_mv in f32
    and the Pallas kernel in interpret mode (the lane shapes of
    test_band.py:170)."""
    rows, cols, n = plate_layout
    lj, lt = _layouts(rows, cols, n)
    rng = np.random.default_rng(11)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    X = rng.standard_normal(shape + (n,)).astype(np.float32)

    band_j = jband.flat_to_band(jnp.asarray(vals), lj, jnp.asarray(lj.lin))
    y_jax = np.asarray(jband.band_mv(band_j, jnp.asarray(X), lj))
    y_pal = np.asarray(band_mv_pallas(band_j, jnp.asarray(X), lj,
                                      interpret=True))
    band_t = tband.flat_to_band(torch.from_numpy(vals), lt,
                                torch.from_numpy(lt.lin.astype(np.int64)))
    np.testing.assert_array_equal(band_t.numpy(), np.asarray(band_j))
    pack = band_kernel.pack_band_tiles(band_t, lt)
    y = band_kernel.band_mv_f32_reference(pack, torch.from_numpy(X),
                                          lt).numpy()
    assert y.shape == X.shape
    den = float(np.abs(y_jax).max())
    assert np.abs(y - y_jax).max() / den <= 1e-6
    assert np.abs(y - y_pal).max() / den <= 1e-6


def test_band_mv_f32_plain_small_blocks():
    """b = 64, which the Pallas row tile does not divide by 128/256."""
    rows, cols, n = _synthetic_b64()
    lj, lt = _layouts(rows, cols, n, block_multiple=64, min_block=64)
    assert lt.b == 64
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    X = rng.standard_normal((8, n)).astype(np.float32)
    band_j = jband.flat_to_band(jnp.asarray(vals), lj, jnp.asarray(lj.lin))
    y_pal = np.asarray(band_mv_pallas(band_j, jnp.asarray(X), lj,
                                      interpret=True))
    band_t = tband.flat_to_band(torch.from_numpy(vals), lt,
                                torch.from_numpy(lt.lin.astype(np.int64)))
    pack = band_kernel.pack_band_tiles(band_t, lt)
    y = band_kernel.band_mv_f32_reference(pack, torch.from_numpy(X),
                                          lt).numpy()
    assert np.abs(y - y_pal).max() / np.abs(y_pal).max() <= 1e-6


def test_band_mv_f64_and_flat_to_band_match_jax(plate_layout):
    rows, cols, n = plate_layout
    lj, lt = _layouts(rows, cols, n)
    rp, cp = tband.permute_pattern(lt, rows, cols)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(rows.size)
    X = rng.standard_normal((5, n))
    band_j = jband.flat_to_band(jnp.asarray(vals), lj, jnp.asarray(lj.lin))
    band_t = tband.flat_to_band(torch.from_numpy(vals), lt,
                                torch.from_numpy(lt.lin.astype(np.int64)))
    np.testing.assert_array_equal(band_t.numpy(), np.asarray(band_j))
    y_j = np.asarray(jband.band_mv(band_j, jnp.asarray(X), lj))
    y_t = tband.band_mv(band_t, torch.from_numpy(X), lt).numpy()
    # row abs-sum sum_j |A_ij x_j| of each output entry
    scale = np.zeros((5, n))
    for k in range(5):
        np.add.at(scale[k], rp, np.abs(vals) * np.abs(X[k, cp]))
    assert np.all(np.abs(y_t - y_j) <= 1e-14 * scale)


def test_rect_band_matches_jax(plate_layout):
    """Rectangular block-band prolongation/restriction on a synthetic
    banded P (fine rows in RCM order), against the JAX package."""
    import scipy.sparse as sp

    rows, cols, n = plate_layout
    lj, lt = _layouts(rows, cols, n)
    rng = np.random.default_rng(5)
    nc = 300
    pr = np.repeat(np.arange(n), 3)
    pc = np.clip((pr * nc) // n + rng.integers(-2, 3, pr.size), 0, nc - 1)
    P = sp.csr_matrix((rng.standard_normal(pr.size), (pr, pc)),
                      shape=(n, nc))
    rj = jband.build_rect_band(P, lj)
    rt = tband.build_rect_band(P, lt)
    for f in ("n_fine", "n_coarse", "nb", "b", "bc", "nd", "hw", "perm_c",
              "slots", "lin", "vals"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
    Pt_j = np.asarray(jband.rect_band_tensor(rj))
    Pt_t = tband.rect_band_tensor(rt, "cpu")
    np.testing.assert_array_equal(Pt_t.numpy(), Pt_j)
    slots = torch.from_numpy(rt.slots.astype(np.int64))
    xc = rng.standard_normal((2, 3, nc)).astype(np.float32)
    rf = rng.standard_normal((2, 3, n)).astype(np.float32)
    y_j = np.asarray(jband.rect_band_mv(jnp.asarray(Pt_j), jnp.asarray(xc),
                                        rj, jnp.asarray(rj.slots)))
    y_t = tband.rect_band_mv(Pt_t, torch.from_numpy(xc), rt, slots).numpy()
    assert np.abs(y_t - y_j).max() <= 1e-6 * np.abs(y_j).max()
    w_j = np.asarray(jband.rect_band_tmv(jnp.asarray(Pt_j), jnp.asarray(rf),
                                         rj, jnp.asarray(rj.slots)))
    w_t = tband.rect_band_tmv(Pt_t, torch.from_numpy(rf), rt, slots).numpy()
    assert np.abs(w_t - w_j).max() <= 1e-6 * np.abs(w_j).max()


@pytest.mark.parametrize("transpose", [False, True])
def test_spmv_flat_matches_jax(plate_layout, transpose):
    """The flat COO matvec (K3's plain version) against the JAX package's
    ``spmv_flat``, f64, batched lanes, A^T through the pattern's rows and
    columns swapped; <= 1e-14 of the row abs-sum (f64 sums in another
    order)."""
    rows, cols, n = plate_layout
    rng = np.random.default_rng(13)
    vals = rng.standard_normal(rows.size)
    X = rng.standard_normal((2, 3, n))
    y_j = np.asarray(jspmv_flat(jnp.asarray(vals), jnp.asarray(rows),
                                jnp.asarray(cols), jnp.asarray(X), n,
                                transpose=transpose))
    r, c = (cols, rows) if transpose else (rows, cols)
    y_t = scatter_mv(torch.from_numpy(vals)[None], torch.from_numpy(X),
                     torch.from_numpy(r).long(), torch.from_numpy(c).long(),
                     n)[0].numpy()
    scale = np.zeros((2, 3, n))
    for idx in np.ndindex(2, 3):
        np.add.at(scale[idx], r, np.abs(vals) * np.abs(X[idx][c]))
    assert y_t.shape == X.shape
    assert np.all(np.abs(y_t - y_j) <= 1e-14 * scale)


def test_cpu_call_does_not_launch_the_kernel(plate_layout):
    """A CPU tensor takes the plain version and leaves the count at 0."""
    rows, cols, n = plate_layout
    _, lt = _layouts(rows, cols, n)
    pack = band_kernel.pack_band_tiles(torch.zeros(lt.nb, lt.b, 3 * lt.b), lt)
    band_kernel.band_mv_f32_cuda.launches = 0
    y = band_kernel.band_mv_f32(pack, torch.ones(4, n), lt)
    assert y.shape == (4, n)
    assert band_kernel.band_mv_f32_cuda.launches == 0


def test_cuda_wrapper_refuses_cpu_tensors(plate_layout):
    """The kernel's wrapper never computes on a CPU tensor."""
    rows, cols, n = plate_layout
    _, lt = _layouts(rows, cols, n)
    pack = band_kernel.pack_band_tiles(torch.ones(lt.nb, lt.b, 3 * lt.b), lt)
    with pytest.raises(ValueError):
        band_kernel.band_mv_f32_cuda(pack, torch.ones(2, n), lt)
