"""The plan of K3's redesigned kernels (``ops/csr_kernel.py build_csr``),
on the CPU: row tiles in reverse Cuthill-McKee order, each with its row
list, its distinct columns and a one-byte slot per nonzero.

The kernels (``csrc/csr_mv.cu``) stage x at a tile's columns and read it
through the slots, summing each row's entries in ascending CSR order; a
plain torch emulation of that order stands in for them here.  It must give
the scatter's (``scatter_mv``) and the JAX package's ``spmv_flat``'s
product on the bench plate's pattern to 1e-13 of max |y| (f64 sums of a
row in another order).  The card cases are in tests/test_torch_kernel.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops.scatter import spmv_flat
from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@functools.lru_cache(maxsize=None)
def _plate_pattern(refine):
    """The flat pattern of the ``sh_i`` strip (isotropic steel, AP1030):
    refine = 1 is the bench plate (n = 1466), 3 the n = 11910 plate."""
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=refine)
    p = pt.Problem(geom, mat, acc, device="cpu")
    return (np.asarray(p.op.pattern.rows), np.asarray(p.op.pattern.cols),
            p.n_free)


def _check_plan(csr):
    """Every invariant the kernels rely on."""
    n, nnz = csr.n, csr.nnz
    tile_ptr, tile_rows, col_ptr, tile_cols, slot, rowptr, col = (
        t.numpy().astype(np.int64) for t in (
            csr.tile_ptr, csr.tile_rows, csr.col_ptr, csr.tile_cols,
            csr.slot, csr.rowptr, csr.col))
    assert csr.slot.dtype == torch.uint8
    # every row in exactly one tile, so every nonzero exactly once
    assert np.array_equal(np.sort(tile_rows), np.arange(n))
    sizes = np.diff(tile_ptr)
    assert tile_ptr[0] == 0 and tile_ptr[-1] == n and np.all(sizes >= 1)
    assert np.all(sizes <= ck.TILE_ROWS) and csr.max_rows == sizes.max()
    tile_of = np.repeat(np.arange(csr.n_tiles), sizes)[np.argsort(tile_rows)]
    assert np.bincount(tile_of[np.repeat(np.arange(n), np.diff(rowptr))],
                       minlength=csr.n_tiles).sum() == nnz
    for t in range(csr.n_tiles):
        assert np.all(np.diff(tile_rows[tile_ptr[t]:tile_ptr[t + 1]]) > 0)
    # each tile's columns distinct and ascending, within the kernel's limits
    counts = np.diff(col_ptr)
    assert csr.max_cols == (counts.max() if counts.size else 0)
    assert csr.max_cols <= ck.MAX_TILE_COLS
    assert ck.smem_bytes(csr.max_rows, csr.max_cols,
                         csr.max_nnz) <= ck.SMEM_BUDGET
    for t in range(csr.n_tiles):
        assert np.all(np.diff(tile_cols[col_ptr[t]:col_ptr[t + 1]]) > 0)
    # each row's entries at its place in its tile's list of entries
    row_off = csr.row_off.numpy().astype(np.int64)
    lens = np.diff(rowptr)
    for t in range(csr.n_tiles):
        r = tile_rows[tile_ptr[t]:tile_ptr[t + 1]]
        assert np.array_equal(row_off[r], np.r_[0, np.cumsum(lens[r])[:-1]])
        assert lens[r].sum() <= csr.max_nnz
    ends = rowptr[np.minimum(np.arange(0, n, ck.L1_ROWS) + ck.L1_ROWS, n)]
    assert n == 0 or csr.max_block_nnz == (ends - rowptr[0:n:ck.L1_ROWS]).max()
    # every slot points at its own column, in its own tile's list
    row_of = np.repeat(np.arange(n), np.diff(rowptr))
    base = col_ptr[tile_of[row_of]]
    assert np.all(slot < counts[tile_of[row_of]])
    assert np.array_equal(tile_cols[base + slot], col)


def _planned(data, x, csr):
    """Plain torch emulation of the tiled kernels' order: x staged at every
    tile's columns, read through the slots, each row's entries summed in
    ascending CSR order."""
    n = csr.n
    d = data if csr.perm is None else data[:, csr.perm]
    x2 = x.reshape(-1, n)
    tile_ptr, tile_rows, col_ptr, tile_cols, slot, rowptr = (
        t.long() for t in (csr.tile_ptr, csr.tile_rows, csr.col_ptr,
                           csr.tile_cols, csr.slot, csr.rowptr))
    staged = x2[:, tile_cols]                     # (L, every tile's columns)
    tile_of = torch.repeat_interleave(
        torch.arange(csr.n_tiles), tile_ptr.diff())[torch.argsort(tile_rows)]
    lens = rowptr.diff()
    acc = torch.zeros(d.shape[0], x2.shape[0], n, dtype=d.dtype)
    for j in range(int(lens.max()) if n else 0):
        live = torch.nonzero(lens > j).flatten()
        k = rowptr[live] + j
        xv = staged[:, col_ptr[tile_of[live]] + slot[k]]
        acc[:, :, live] += d[:, k][:, None, :] * xv[None]
    return acc.reshape((d.shape[0],) + x.shape[:-1] + (n,))


@pytest.mark.parametrize("refine", [1.0, 3.0])
def test_plan_invariants_on_plate_patterns(refine):
    """The bench plate's pattern (n = 1466) and the n = 11910 one: every
    nonzero once, every slot at its own column, every tile within 256
    columns and the shared-memory budget; the RCM tiles touch far fewer
    columns than the rows' own count of nonzeros."""
    rows, cols, n = _plate_pattern(refine)
    csr = ck.build_csr(torch.as_tensor(rows), torch.as_tensor(cols), n)
    assert csr.perm is None
    _check_plan(csr)
    # every tile holds whole groups of ROW_GROUP consecutive rows (no group
    # of these plates is too wide), so y goes out in whole sectors
    rows = csr.tile_rows.numpy()
    ends = csr.tile_ptr.numpy()
    g = ck.ROW_GROUP
    for t in range(csr.n_tiles):
        groups, counts = np.unique(rows[ends[t]:ends[t + 1]] // g,
                                   return_counts=True)
        assert np.all(counts == np.minimum(g, n - groups * g))
    # x reuse of the staged columns: nonzeros per staged column (3.8 at n
    # = 1466 and 4.5 at 11910, against ~2.2 in 32-row tiles of the natural
    # order)
    assert csr.nnz / csr.tile_cols.numel() > 3.5


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300),
       wide=st.integers(0, 200))
def test_plan_invariants_on_irregular_patterns(seed, n, wide):
    """Random shuffled patterns with empty rows, repeated entries and rows
    up to ``wide`` distinct columns (groups of rows that would hold more
    than 256 go in single rows): the invariants hold and the planned order
    gives the scatter's product."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max(1, min(n, wide)) + 1, n)
    lens[rng.random(n) < 0.1] = 0
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, rows.size)
    perm = rng.permutation(rows.size)
    rows, cols = torch.as_tensor(rows[perm]), torch.as_tensor(cols[perm])
    csr = ck.build_csr(rows, cols, n)
    _check_plan(csr)
    data = torch.as_tensor(rng.standard_normal((2, rows.numel())))
    x = torch.as_tensor(rng.standard_normal((3, n)))
    y_ref = ck.scatter_mv(data, x, rows, cols, n)
    tol = 1e-13 * max(float(y_ref.abs().max()), 1e-300)
    assert float((_planned(data, x, csr) - y_ref).abs().max()) <= tol


def test_plan_raises_on_a_row_too_wide():
    """A row with more distinct columns than a tile holds cannot be split:
    the plan raises instead of handing the kernel an overfull tile."""
    n = 400
    rows = np.r_[np.zeros(300, np.int64), np.arange(1, n)]
    cols = np.r_[np.arange(300), np.arange(1, n)]
    with pytest.raises(ValueError, match="distinct columns"):
        ck.build_csr(torch.as_tensor(rows), torch.as_tensor(cols), n)


def test_planned_order_matches_scatter_and_jax():
    """On the bench plate's pattern (n = 1466), S = 2 operators on 8 lanes:
    the planned order against the port's scatter and the JAX package's
    ``spmv_flat``, to 1e-13 of max |y|."""
    rows, cols, n = _plate_pattern(1.0)
    csr = ck.build_csr(torch.as_tensor(rows), torch.as_tensor(cols), n)
    rng = np.random.default_rng(11)
    data = rng.standard_normal((2, rows.size))
    x = rng.standard_normal((8, n))
    y = _planned(torch.as_tensor(data), torch.as_tensor(x), csr).numpy()
    y_scatter = ck.scatter_mv(torch.as_tensor(data), torch.as_tensor(x),
                              torch.as_tensor(rows), torch.as_tensor(cols),
                              n).numpy()
    y_jax = np.stack([np.asarray(spmv_flat(jnp.asarray(data[s]),
                                           jnp.asarray(rows),
                                           jnp.asarray(cols),
                                           jnp.asarray(x), n))
                      for s in range(2)])
    tol = 1e-13 * np.abs(y_jax).max()
    assert y.shape == y_jax.shape == (2, 8, n)
    assert np.abs(y - y_scatter).max() <= tol
    assert np.abs(y - y_jax).max() <= tol
