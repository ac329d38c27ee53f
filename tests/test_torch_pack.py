"""The packed band of the port's f32 band matvec (plate_inverse_problem_tpu_torch/
ops/band_kernel.py: ``pack_band_tiles`` and the plain version on the pack)
on the CPU, held against the dense band and the dense ``ops/band.band_mv``.

Patterns: the n = 1466 ``sh_i`` plate (refine = 1, b = 256, nb = 6) and the
b = 64 synthetic narrow band of test_band.py:203-213, with values from numpy
seeds.  Tolerances: the pack and its unpacking are exact (a copy of the
band's values); the packed product agrees with the dense one to 1e-6 of
max |y| (the f32 sums of a row run in another order).
"""
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.ops import band as tband
from plate_inverse_problem_tpu_torch.ops import band_kernel
from plate_inverse_problem_tpu_torch.ops.band_kernel import (
    TILE, BandTiles, pack_band_tiles)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)


def _plate_parts():
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), refine=1.0)
    return geom, mat, acc


@pytest.fixture(scope="module")
def layouts():
    """{name: (pattern rows, cols, band layout)} of the two patterns."""
    p = pt.Problem(*_plate_parts(), device="cpu", precond="mg",
                   operator_layout="band")
    n, w = 400, 9
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    out = {"plate": (p.op.pattern.rows, p.op.pattern.cols,
                     tband.build_band_layout(p.op.pattern.rows,
                                             p.op.pattern.cols, p.n_free)),
           "b64": (rows, cols, tband.build_band_layout(
               rows, cols, n, block_multiple=64, min_block=64))}
    assert (out["plate"][2].b, out["plate"][2].nb, out["b64"][2].b) \
        == (256, 6, 64)
    return out


def _band(rows, lt, seed):
    """f32 band of random values on the pattern (zeros elsewhere)."""
    vals = np.random.default_rng(seed).standard_normal(rows.size)
    return tband.flat_to_band(torch.as_tensor(vals, dtype=torch.float32), lt,
                              torch.from_numpy(lt.lin.astype(np.int64)))


def _in_range(lt):
    """(nb, b, 3b) mask of the window slots inside the operator."""
    q = torch.arange(lt.nb)[:, None]
    row = q * lt.b + torch.arange(lt.b)
    col = (q - 1) * lt.b + torch.arange(3 * lt.b)
    return (row < lt.n)[:, :, None] & ((col >= 0) & (col < lt.n))[:, None, :]


def _unpack(pack, lt):
    """The pack scattered back into a dense (nb, b, 3b) band."""
    tm, tk = pack.tile
    counts = pack.row_ptr.diff().long()
    rt = torch.repeat_interleave(torch.arange(pack.n_row_tiles), counts)
    q = rt // (lt.b // tm)
    r0 = (rt % (lt.b // tm)) * tm
    c0 = pack.col0.long() - (q - 1) * lt.b
    band = torch.zeros(lt.nb, lt.b, 3 * lt.b)
    for t in range(pack.vals.shape[0]):
        band[q[t], r0[t]:r0[t] + tm, c0[t]:c0[t] + tk] = pack.vals[t]
    return band


@pytest.mark.parametrize("name", ["plate", "b64"])
def test_unpack_gives_the_band_with_out_of_range_slots_zeroed(layouts, name):
    rows, _, lt = layouts[name]
    g = torch.Generator().manual_seed(1)
    # the pattern's values, and garbage in every slot outside the pattern
    band = _band(rows, lt, 1)
    band = torch.where(band != 0, band,
                       torch.randn(lt.nb, lt.b, 3 * lt.b, generator=g))
    pack = pack_band_tiles(band, lt)
    assert pack.tile == TILE and pack.vals.dtype == torch.float32
    assert pack.col0.dtype == pack.row_ptr.dtype == torch.int32
    assert pack.n_row_tiles == lt.nb * lt.b // TILE[0]
    assert int(pack.row_ptr[-1]) == pack.vals.shape[0]
    assert pack.list_max == int(pack.row_ptr.diff().max())
    torch.testing.assert_close(_unpack(pack, lt),
                               torch.where(_in_range(lt), band, 0.0),
                               rtol=0, atol=0)
    # every packed tile holds a nonzero; a row tile's tiles in column order
    assert bool((pack.vals != 0).flatten(1).any(1).all())
    c0 = pack.col0.long()
    for r in range(pack.n_row_tiles):
        seg = c0[int(pack.row_ptr[r]):int(pack.row_ptr[r + 1])]
        assert bool((seg.diff() > 0).all())
    assert int(c0.min()) >= 0 and int(c0.max()) < lt.n


@pytest.mark.parametrize("B", [1, 3, 128, 200])
@pytest.mark.parametrize("name", ["plate", "b64"])
def test_packed_plain_matches_dense_band_mv(layouts, name, B):
    rows, _, lt = layouts[name]
    band = _band(rows, lt, B)
    x = torch.as_tensor(np.random.default_rng(B + 1).standard_normal(
        (B, lt.n)), dtype=torch.float32)
    y = band_kernel.band_mv_f32(pack_band_tiles(band, lt), x, lt)
    y_ref = tband.band_mv(band, x, lt)
    assert y.shape == (B, lt.n) and y.dtype == torch.float32
    assert float((y - y_ref).abs().max()) <= 1e-6 * float(y_ref.abs().max())


def test_pack_ignores_out_of_range_garbage(layouts):
    """Garbage (even inf and NaN) in the slots outside [0, n) and in the
    rows >= n changes neither the pack nor the product."""
    rows, _, lt = layouts["plate"]
    band = _band(rows, lt, 5)
    junk = torch.randn(lt.nb, lt.b, 3 * lt.b,
                       generator=torch.Generator().manual_seed(5))
    junk[0, 0, 0] = float("nan")
    junk[-1, -1, -1] = float("inf")
    dirty = torch.where(_in_range(lt), band, junk)
    a, b = pack_band_tiles(band, lt), pack_band_tiles(dirty, lt)
    for f in ("vals", "col0", "row_ptr"):
        torch.testing.assert_close(getattr(b, f), getattr(a, f), rtol=0,
                                   atol=0)
    x = torch.randn(4, lt.n, generator=torch.Generator().manual_seed(6))
    y = band_kernel.band_mv_f32(b, x, lt)
    y_ref = tband.band_mv(band, x, lt)
    assert bool(torch.isfinite(y).all())
    assert float((y - y_ref).abs().max()) <= 1e-6 * float(y_ref.abs().max())


def test_empty_row_tiles_give_zero(layouts):
    """Row tiles with no tile (an emptied block row, the padded tail) give
    0 in every row they hold."""
    rows, _, lt = layouts["plate"]
    band = _band(rows, lt, 8)
    band[2] = 0.0                                 # block row 2: rows 512-767
    pack = pack_band_tiles(band, lt)
    per_tile = pack.row_ptr.diff()
    tiles_per_block = lt.b // TILE[0]
    assert bool((per_tile[2 * tiles_per_block:3 * tiles_per_block] == 0).all())
    assert bool((per_tile[-(-lt.n // TILE[0]):] == 0).all())   # the tail
    x = torch.randn(3, lt.n, generator=torch.Generator().manual_seed(8))
    y = band_kernel.band_mv_f32(pack, x, lt)
    assert bool((y[:, 2 * lt.b:3 * lt.b] == 0).all())
    y_ref = tband.band_mv(band, x, lt)
    assert float((y - y_ref).abs().max()) <= 1e-6 * float(y_ref.abs().max())


def test_dense_band_is_refused(layouts):
    rows, _, lt = layouts["b64"]
    band = _band(rows, lt, 2)
    x = torch.ones(2, lt.n)
    with pytest.raises(TypeError, match="pack"):
        band_kernel.band_mv_f32(band, x, lt)
    with pytest.raises(TypeError, match="pack"):
        band_kernel.band_mv_f32_cuda(band, x, lt)


def test_pack_is_built_once_per_problem(monkeypatch):
    """getFRCore packs the band once; two solveForward calls reuse it."""
    built = []

    def counting(*a, **k):
        built.append(1)
        return pack_band_tiles(*a, **k)

    monkeypatch.setattr(band_kernel, "pack_band_tiles", counting)
    p = pt.Problem(*_plate_parts(), device="cpu", precond="mg",
                   operator_layout="band")
    freqs = np.array([100.0, 152.0])
    y1 = p.solveForward(freqs)
    pack = p._band_pack
    y2 = p.solveForward(freqs)
    assert len(built) == 1 and p._band_pack is pack
    assert isinstance(pack, BandTiles) and p._pack_build_s > 0
    torch.testing.assert_close(y2, y1, rtol=1e-12, atol=0)
