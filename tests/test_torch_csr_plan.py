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
    long_rows = csr.long_rows.numpy().astype(np.int64)
    assert csr.slot.dtype == torch.uint8
    # every row in exactly one tile or among the long rows (ascending), so
    # every nonzero exactly once
    assert np.array_equal(np.sort(np.r_[tile_rows, long_rows]), np.arange(n))
    assert np.all(np.diff(long_rows) > 0)
    sizes = np.diff(tile_ptr)
    assert tile_ptr[0] == 0 and tile_ptr[-1] == n - long_rows.size
    assert np.all(sizes >= 1) and np.all(sizes <= ck.TILE_ROWS)
    assert csr.max_rows == (sizes.max() if sizes.size else 0)
    tile_of = np.full(n, -1)
    tile_of[tile_rows] = np.repeat(np.arange(csr.n_tiles), sizes)
    row_of = np.repeat(np.arange(n), np.diff(rowptr))
    in_tile = tile_of[row_of] >= 0
    assert (np.bincount(tile_of[row_of[in_tile]], minlength=csr.n_tiles).sum()
            + np.diff(rowptr)[long_rows].sum()) == nnz
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
    # the one-lane kernel stages each block's rows but the long ones
    ends = rowptr[np.minimum(np.arange(0, n, ck.L1_ROWS) + ck.L1_ROWS, n)]
    runs = ends - rowptr[0:n:ck.L1_ROWS]
    for i in long_rows:
        runs[i // ck.L1_ROWS] -= rowptr[i + 1] - rowptr[i]
    assert n == 0 or csr.max_block_nnz == min(runs.max(), ck.L1_STAGE_MAX)
    # the long rows' plan, field for field against a row-by-row reference
    ref = _long_plan_reference(rowptr, col, long_rows, csr.n_cols)
    perm = (np.arange(nnz) if csr.perm is None
            else csr.perm.numpy().astype(np.int64))
    ref["long_src"] = [int(perm[k]) for i in long_rows
                       for k in range(rowptr[i], rowptr[i + 1])]
    segs = [-(-(rowptr[i + 1] - rowptr[i]) // ck.LONG_SEG) for i in long_rows]
    ref["long_segptr"] = np.cumsum([0] + segs).tolist() if segs else []
    ref["long_segrow"] = [q for q, m in enumerate(segs) for _ in range(m)]
    for k, v in ref.items():
        got = getattr(csr, k)
        got = got if isinstance(got, tuple) else got.numpy().tolist()
        assert got == v, k
    # every slot points at its own column, in its own tile's list
    base = col_ptr[tile_of[row_of[in_tile]]]
    assert np.all(slot[in_tile] < counts[tile_of[row_of[in_tile]]])
    assert np.array_equal(tile_cols[base + slot[in_tile]], col[in_tile])
    # a long row is in no tile because it fits none: no offset, slots 0
    assert np.all(row_off[long_rows] == -1) and np.all(slot[~in_tile] == 0)
    for i in long_rows:
        k = col[rowptr[i]:rowptr[i + 1]]
        assert (np.unique(k).size > ck.MAX_TILE_COLS
                or k.size > ck.MAX_TILE_NNZ)


def _long_plan_reference(rowptr, col, long_rows, width):
    """The long rows' plan built row by row, group by group (lists)."""
    G, W = ck.LONG_GROUP, ck.LONG_WIN
    out = {k: [] for k in ("long_wptr", "long_win", "long_kptr",
                           "long_xi", "long_koff")}
    stage_max = [0] * len(ck.LONG_BATCHES)
    if len(long_rows) == 0:
        return out | {"long_stage_max": tuple(stage_max)}
    e = 0
    out["long_wptr"].append(0)
    for g0 in range(0, len(long_rows), G):
        group = long_rows[g0:g0 + G]
        cols = [col[rowptr[i]:rowptr[i + 1]] for i in group]
        wins = sorted({int(c) // W for cs in cols for c in cs})
        out["long_win"] += wins
        out["long_wptr"].append(len(out["long_win"]))
        place = {w: j for j, w in enumerate(wins)}
        kptr = np.zeros((len(wins) + 1, G), np.int64)
        for r, (i, cs) in enumerate(zip(group, cols)):
            out["long_koff"].append(int(rowptr[i]) - e)
            for j, w in enumerate(wins):
                # the row's first entry in window w
                kptr[j, r] = e + int(np.count_nonzero(cs // W < w))
            kptr[len(wins), r] = e + len(cs)
            out["long_xi"] += [place[int(c) // W] * W + int(c) % W
                               for c in cs]
            e += len(cs)
        out["long_kptr"] += kptr.ravel().tolist()
        for b, c in enumerate(ck.LONG_BATCHES):
            for j0 in range(0, len(wins), c):
                j1 = min(j0 + c, len(wins))
                stage_max[b] = max(stage_max[b],
                                   int((kptr[j1] - kptr[j0]).sum()))
    return out | {"long_stage_max": tuple(stage_max)}


def _planned(data, x, csr):
    """Plain torch emulation of the kernels' order: x staged at every
    tile's columns, read through the slots, each row's entries summed in
    ascending CSR order; a long row's entries in that order too, x staged
    over its group's windows and read at the entries' ``long_xi``."""
    n, n_cols = csr.n, csr.n_cols
    d = data if csr.perm is None else data[:, csr.perm]
    x2 = x.reshape(-1, n_cols)
    tile_ptr, tile_rows, col_ptr, tile_cols, slot, rowptr = (
        t.long() for t in (csr.tile_ptr, csr.tile_rows, csr.col_ptr,
                           csr.tile_cols, csr.slot, csr.rowptr))
    staged = x2[:, tile_cols]                     # (L, every tile's columns)
    # each long entry's x: its group's windows staged, read at its place
    wptr, win, xi, koff = (t.long() for t in (
        csr.long_wptr, csr.long_win, csr.long_xi, csr.long_koff))
    x_long = torch.zeros(x2.shape[0], csr.nnz, dtype=x2.dtype)
    for q, i in enumerate(csr.long_rows.long().tolist()):
        g = q // ck.LONG_GROUP
        wins = win[wptr[g]:wptr[g + 1]]
        cols = (wins[:, None] * ck.LONG_WIN
                + torch.arange(ck.LONG_WIN)).ravel().clamp(max=n_cols - 1)
        e = torch.arange(rowptr[i] - koff[q], rowptr[i + 1] - koff[q])
        x_long[:, e + koff[q]] = x2[:, cols][:, xi[e]]
    tile_of = torch.full((n,), -1, dtype=torch.long)
    tile_of[tile_rows] = torch.repeat_interleave(
        torch.arange(csr.n_tiles), tile_ptr.diff())
    lens = rowptr.diff()
    acc = torch.zeros(d.shape[0], x2.shape[0], n, dtype=d.dtype)
    for j in range(int(lens.max()) if n else 0):
        live = torch.nonzero(lens > j).flatten()
        k = rowptr[live] + j
        t = tile_of[live]
        xv = torch.where(t >= 0, staged[:, col_ptr[t.clamp(min=0)] + slot[k]],
                         x_long[:, k])
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
    the plan hands it to the long-row kernel instead of an overfull tile
    (it no longer raises), and the other rows keep their tiles; the
    planned order still gives the scatter's product."""
    n = 400
    rows = np.r_[np.zeros(300, np.int64), np.arange(1, n)]
    cols = np.r_[np.arange(300), np.arange(1, n)]
    csr = ck.build_csr(torch.as_tensor(rows), torch.as_tensor(cols), n)
    assert csr.long_rows.tolist() == [0] and csr.n_long == 1
    _check_plan(csr)
    rng = np.random.default_rng(5)
    data = torch.as_tensor(rng.standard_normal((2, rows.size)))
    x = torch.as_tensor(rng.standard_normal((3, n)))
    y_ref = ck.scatter_mv(data, x, torch.as_tensor(rows),
                          torch.as_tensor(cols), n)
    tol = 1e-13 * float(y_ref.abs().max())
    assert float((_planned(data, x, csr) - y_ref).abs().max()) <= tol


def _long_pattern(case, rng):
    """(rows, cols, n_rows, n_cols) of a pattern with long rows, shuffled:
    "mixed" a band of 5 columns a row on 700 rows, every 9th row with
    257-600 more distinct random columns (78 long rows, three groups);
    "exact" one row of exactly 257 distinct columns and one over all 700;
    "rect" a 150 x 1500 restriction-like pattern, every 4th row with
    300-1200 columns of its own stretch of the 1500 and the rest 9
    (P^T-like: its rows' columns run together)."""
    rows, cols = [], []
    n_rows, n_cols = (150, 1500) if case == "rect" else (700, 700)
    for i in range(n_rows):
        j = i * n_cols // n_rows
        c = np.arange(max(0, j - 4), min(n_cols, j + 5))
        if case == "mixed" and i % 9 == 4:
            c = np.union1d(c[2:7], rng.choice(n_cols, int(rng.integers(
                257, 601)), replace=False))
        elif case == "exact" and i in (3, 500):
            c = (np.sort(rng.choice(n_cols, 257, replace=False)) if i == 3
                 else np.arange(n_cols))
        elif case == "rect" and i % 4 == 1:
            w = int(rng.integers(300, 1201))
            c = np.arange(max(0, min(j, n_cols - w)),
                          max(0, min(j, n_cols - w)) + w)
        rows.append(np.full(c.size, i))
        cols.append(c)
    r, c = np.concatenate(rows), np.concatenate(cols)
    perm = rng.permutation(r.size)
    return r[perm], c[perm], n_rows, n_cols


@pytest.mark.parametrize("case", ["mixed", "exact", "rect"])
def test_long_plan_and_its_order(case):
    """Patterns with long rows (mixed, a row of exactly 257 distinct
    columns and one over every column, a rectangular one): the long rows'
    plan is the row-by-row reference's field for field (``_check_plan``),
    every long row's windows cover its columns, and the kernels' order
    (x staged over a group's windows) gives the scatter's product to 1e-13
    of max |y|."""
    rng = np.random.default_rng(["mixed", "exact", "rect"].index(case))
    r, c, n_rows, n_cols = _long_pattern(case, rng)
    csr = ck.build_csr(torch.as_tensor(r), torch.as_tensor(c), n_rows, n_cols)
    want = {"mixed": 78, "exact": 2, "rect": 38}[case]
    assert csr.n_long == want and csr.n_groups == -(-want // ck.LONG_GROUP)
    _check_plan(csr)
    data = torch.as_tensor(rng.standard_normal((3, r.size)))
    x = torch.as_tensor(rng.standard_normal((2, n_cols)))
    y_ref = ck.scatter_mv(data, x, torch.as_tensor(r), torch.as_tensor(c),
                          n_rows)
    tol = 1e-13 * float(y_ref.abs().max())
    assert float((_planned(data, x, csr) - y_ref).abs().max()) <= tol


# the bench pattern's plan as PR 15's build_csr made it: sha256 of each
# array's bytes (first 16 hex digits) and its sizes
BENCH_PLAN = {
    "rowptr": "99ef75b8abdc698b", "col": "87cee4ce1d82d704",
    "tile_ptr": "24ea29d5b96c7d1b", "tile_rows": "11624349554ed652",
    "col_ptr": "c85f706adb4c5899", "tile_cols": "507309bb4c5affb9",
    "slot": "e5d1873c7a8e63a5", "row_off": "b8a47654172d890a",
    "long_rows": "e3b0c44298fc1c14", "max_rows": 32, "max_cols": 256,
    "max_nnz": 998, "max_block_nnz": 4262, "n_tiles": 47,
    "plan_bytes": 88020}


def test_bench_plan_is_unchanged():
    """The bench plate's plan (n = 1466, no long row) is the one the tile
    kernels always had, field for field; its long-row plan is empty."""
    import hashlib

    rows, cols, n = _plate_pattern(1.0)
    csr = ck.build_csr(torch.as_tensor(rows), torch.as_tensor(cols), n)
    got = {k: (getattr(csr, k) if not isinstance(getattr(csr, k),
                                                 torch.Tensor)
               else hashlib.sha256(getattr(csr, k).numpy().tobytes())
               .hexdigest()[:16]) for k in BENCH_PLAN}
    assert got == BENCH_PLAN and csr.perm is None
    assert csr.n_long == csr.n_groups == 0
    assert csr.long_stage_max == (0,) * len(ck.LONG_BATCHES)
    assert all(getattr(csr, k).numel() == 0 for k in (
        "long_wptr", "long_win", "long_kptr", "long_xi", "long_koff",
        "long_src", "long_segptr", "long_segrow"))


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
