"""K3: the flat-pattern operator as a hand-written CUDA kernel
(``csrc/csr_mv.cu``), a stacked CSR matvec with no atomics.

Counterpart of the JAX package's ``ops/mixed.py`` ``_fused_mv`` (l.651) and
``ops/scatter.py`` ``spmv_flat`` (l.22), which XLA runs as segmented
scatters (no Pallas kernel).  S operators on one sparsity pattern (K, M
and K_im, or the tangents of their data) applied to L lanes:

    y[s, ..., i] = sum_{k in row i} data[s, k] * x[..., col[k]]

The pattern may be rectangular, n_rows x n_cols (x (..., n_cols), y (S,
..., n_rows)): the multilevel cycle's prolongations P and restrictions
P^T (ops/mg.py) and the sparse API's products (ops/sparse_api.py) run on
it too; a square pattern has the plan and the bits it always had.

Every output element is summed in one fixed order (its row's entries in
ascending CSR order, one FMA each), so two launches give the same bits;
the ``index_add_`` scatter that ran here before summed with f64 atomics in
no fixed order, and FGMRES carried that last-bit noise up to its
tolerance.  The pieces:

* ``CSRPattern`` / ``build_csr`` — a CSR copy of the flat (rows, cols)
  pattern (rows sorted, a ``rowptr`` added) and the kernel's plan: row
  tiles in reverse Cuthill-McKee order, each with its row list, its
  distinct columns and a one-byte slot per nonzero into them; built once
  per ``getFRCore``;
* ``scatter_mv`` — the plain torch version: ``index_add_`` over the flat
  COO pattern, used for CPU tensors and as the kernel's reference;
* ``csr_mv_cuda`` — checks its inputs, picks the kernel from the lane
  count L (``regime``: one lane, narrow, wide), hands the data and x over
  where they lie (the data through the CSR permutation, x by its strides),
  allocates the output with ``torch.empty``, launches one kernel on the
  current stream and raises if the launch fails;
  ``csr_mv_cuda.launches`` counts the kernels launched, as the C launcher
  reports them, and ``csr_mv_cuda.launches_by_regime`` the same by regime;
* ``csr_mv`` — the dispatch: the kernel for a CUDA tensor, the plain
  version for a CPU tensor, nothing else;
* ``CSRMatVec`` / ``csr_apply`` — the same map as a
  ``torch.autograd.Function`` for the residual map of the adjoint Jacobian
  and the loss gradient: ``jvp`` is the map on the tangent data (it is
  linear), ``backward`` for ``data`` is a gather and a sum over the lanes
  (no scatter), ``vmap`` folds batched data into the operator stack; x is
  a constant, unless the transposed pattern's plan is given (the sparse
  API's ``matvec``): then its cotangent is one K3 product on that plan;
* ``build`` — compiles the source with ``nvcc`` for ``sm_90a`` into
  ``build/kernels/`` at first use, and loads it with ``ctypes``.

Nothing here falls back: a CUDA tensor always goes to the kernel, and a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .band_kernel import BUILD_DIR, _PKG_DIR, compile_source

SOURCE = os.path.join(_PKG_DIR, "csrc", "csr_mv.cu")
_LIB_PATH = os.path.join(BUILD_DIR, "libcsr_mv.so")

# rows of a plan tile at most, and the consecutive rows that stay together in
# one (the choice of both is argued in csrc/csr_mv.cu)
TILE_ROWS = 32
ROW_GROUP = 4
# distinct columns a tile may hold: its slots are one byte
MAX_TILE_COLS = 256
# the kernel's shapes, mirrored from csrc/csr_mv.cu: lanes of a wide block,
# operators summed at once, rows of a one-lane block, and the shared memory
# a block may use with two on an H100 SM (228 KB, 1 KB reserved a block)
WIDE_LANES = 32
OP_GROUP = 2
L1_ROWS = 128
SMEM_BUDGET = 115712

_lib = None


@dataclass(frozen=True)
class CSRPattern:
    """A flat (rows, cols) pattern of n x n_cols operators (n rows; n_cols
    = n for the square operators of a plate) with its CSR copy and the
    kernel's plan.

    ``rows``/``cols`` (nnz,) int64: the flat pattern in the operator data's
    own order (the plain version's); ``rowptr`` (n + 1,) and ``col`` (nnz,)
    int32: the CSR copy, rows ascending, each row's entries by column;
    ``perm`` (nnz,) int32, the flat slot of every CSR slot, or None where
    the flat order is already the CSR order (the kernels read the data
    through it; nothing reorders them).

    The plan: the rows in T tiles of at most TILE_ROWS rows, formed
    from groups of ROW_GROUP consecutive rows in reverse Cuthill-McKee
    order (``_plan``); tile t's rows are
    ``tile_rows[tile_ptr[t]:tile_ptr[t + 1]]`` (int32, ascending), its
    distinct columns ``tile_cols[col_ptr[t]:col_ptr[t + 1]]`` (int32,
    ascending, at most MAX_TILE_COLS), ``slot`` (nnz,) uint8 gives each
    CSR entry's place in its row's tile list, in CSR order, and ``row_off``
    (n,) int32 each row's first entry in its tile's list of entries (its
    rows' entries in row order).  ``max_rows`` / ``max_cols`` /
    ``max_nnz``: the largest tile's; ``max_block_nnz``: the most entries
    L1_ROWS consecutive rows hold; ``plan_s``: ``build_csr``'s host
    seconds."""
    rows: torch.Tensor
    cols: torch.Tensor
    rowptr: torch.Tensor
    col: torch.Tensor
    perm: torch.Tensor | None
    n: int
    n_cols: int
    tile_ptr: torch.Tensor
    tile_rows: torch.Tensor
    col_ptr: torch.Tensor
    tile_cols: torch.Tensor
    slot: torch.Tensor
    row_off: torch.Tensor
    max_rows: int
    max_cols: int
    max_nnz: int
    max_block_nnz: int
    plan_s: float

    @property
    def nnz(self) -> int:
        return self.col.numel()

    @property
    def n_tiles(self) -> int:
        return self.tile_ptr.numel() - 1

    @property
    def plan_bytes(self) -> int:
        """Bytes of the index data the tiled kernels read: the slots, the
        row and column lists with their pointers and offsets, ``rowptr``
        and ``perm`` where there is one."""
        return sum(t.numel() * t.element_size() for t in (
            self.slot, self.tile_rows, self.tile_cols, self.tile_ptr,
            self.col_ptr, self.row_off, self.rowptr) + (
                () if self.perm is None else (self.perm,)))


def smem_bytes(rows: int, cols: int, nnz: int, itemsize: int = 8) -> int:
    """Shared memory of the largest block (the wide kernel's, csrc/
    csr_mv.cu) for a tile of ``rows`` rows, ``cols`` distinct columns and
    ``nnz`` entries: its staged x, its output tile and staged entries for
    OP_GROUP operators, its row list and slots."""
    return (itemsize * (cols * (WIDE_LANES + 2)
                        + OP_GROUP * WIDE_LANES * (rows | 1)
                        + OP_GROUP * nnz) + 4 * rows + nnz)


# the most entries a tile may hold: what the budget leaves beside
# MAX_TILE_COLS columns
MAX_TILE_NNZ = ((SMEM_BUDGET - smem_bytes(TILE_ROWS, MAX_TILE_COLS, 0))
                // (OP_GROUP * 8 + 1))


def _plan(rowptr: np.ndarray, col: np.ndarray, n: int, width: int):
    """The kernel's row tiles (see ``CSRPattern``) for n rows on width
    columns.  The rows go in groups of ROW_GROUP consecutive rows (so y is
    written in whole 32-byte sectors), the groups in reverse Cuthill-McKee
    order of their symmetric structure (of the graph of groups that share
    a column group, where the pattern is rectangular); a tile takes groups
    in that order while it holds at most
    TILE_ROWS rows, MAX_TILE_COLS distinct columns and MAX_TILE_NNZ entries
    (so every block fits SMEM_BUDGET), and the next group starts a new
    one.  A group that alone holds too much is split into its rows;
    raises ValueError where a single row does."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    g = ROW_GROUP
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(rowptr))
    ng = -(-n // g)
    A = sp.csr_matrix((np.ones(col.size, np.int8), (row_of // g, col // g)),
                      shape=(ng, -(-width // g)))
    G = A + A.T if width == n else A.astype(np.int32) @ A.T.astype(np.int32)
    order = reverse_cuthill_mckee(G.tocsr(), symmetric_mode=True)

    def fits(rows, cols, nnz):
        return (rows <= TILE_ROWS and cols <= MAX_TILE_COLS
                and nnz <= MAX_TILE_NNZ)

    # every group's distinct columns, and every row's where a group is split
    gkeys = np.unique((row_of // g) * width + col)
    gptr = np.searchsorted(gkeys, np.arange(ng + 1) * width)
    units = []                         # (first row, rows, entries, columns)
    for q in order:
        r0, r1 = q * g, min(n, q * g + g)
        cols = gkeys[gptr[q]:gptr[q + 1]] % width
        if fits(r1 - r0, cols.size, rowptr[r1] - rowptr[r0]):
            units.append((r0, r1 - r0, rowptr[r1] - rowptr[r0], cols))
            continue
        for i in range(r0, r1):
            cols = np.unique(col[rowptr[i]:rowptr[i + 1]])
            if not fits(1, cols.size, rowptr[i + 1] - rowptr[i]):
                raise ValueError(
                    f"row {i} has {rowptr[i + 1] - rowptr[i]} entries on "
                    f"{cols.size} distinct columns, more than a tile of the "
                    f"kernel can hold ({MAX_TILE_COLS} columns, "
                    f"{MAX_TILE_NNZ} entries).")
            units.append((i, 1, rowptr[i + 1] - rowptr[i], cols))
    # greedy tiles over the units, a column marker for the running union
    mark = np.zeros(width, bool)
    tile_of = np.empty(n, np.int64)
    touched, n_rows, n_nnz, n_cols, t = [], 0, 0, 0, 0
    for r0, nr, ne, cols in units:
        new = cols[~mark[cols]]
        if touched and not fits(n_rows + nr, n_cols + new.size, n_nnz + ne):
            mark[np.concatenate(touched)] = False
            touched, n_rows, n_nnz, n_cols, t = [], 0, 0, 0, t + 1
            new = cols
        mark[new] = True
        touched.append(new)
        n_rows += nr
        n_nnz += ne
        n_cols += new.size
        tile_of[r0:r0 + nr] = t
    n_tiles = t + 1 if n else 0
    keys = tile_of[row_of] * width + col
    ukeys = np.unique(keys)
    counts = np.bincount(ukeys // width, minlength=n_tiles)
    sizes = np.bincount(tile_of, minlength=n_tiles)
    col_ptr = np.r_[0, np.cumsum(counts)]
    slot = np.searchsorted(ukeys, keys) - col_ptr[tile_of[row_of]]
    tile_rows = np.lexsort((np.arange(n), tile_of))   # by tile, then row
    # each row's first entry in its tile's list of entries (rows in order)
    lens = np.diff(rowptr)[tile_rows]
    tile_ptr = np.r_[0, np.cumsum(sizes)]
    run = np.r_[0, np.cumsum(lens)]
    row_off = np.empty(n, np.int64)
    row_off[tile_rows] = run[:-1] - np.repeat(run[tile_ptr[:-1]], sizes)
    tile_nnz = np.diff(run[tile_ptr])
    return (tile_ptr, tile_rows, col_ptr, ukeys % width, slot, row_off,
            int(sizes.max()) if n else 0,
            int(counts.max()) if counts.size else 0,
            int(tile_nnz.max()) if tile_nnz.size else 0)


def build_csr(rows, cols, n: int, n_cols: int | None = None) -> CSRPattern:
    """The CSR copy of the flat pattern (rows, cols) (tensors on the
    operator data's device) of n x n_cols operators (None: square) and the
    kernel's plan, both built on the host and kept on that device."""
    t0 = time.perf_counter()
    n_cols = int(n) if n_cols is None else int(n_cols)
    dev = rows.device
    r = rows.detach().cpu().numpy().astype(np.int64)
    c = cols.detach().cpu().numpy().astype(np.int64)
    if r.size >= 2**31:
        raise ValueError(f"{r.size} nonzeros exceed the kernel's int32 index.")
    order = np.argsort(r * n_cols + c, kind="stable")
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(r, minlength=n))
    perm = (None if np.array_equal(order, np.arange(r.size))
            else torch.as_tensor(order, dtype=torch.int32, device=dev))
    col = c[order]
    (tile_ptr, tile_rows, col_ptr, tile_cols, slot, row_off, max_rows,
     max_cols, max_nnz) = _plan(rowptr, col, int(n), n_cols)
    # the one-lane kernel stages the entries of L1_ROWS consecutive rows
    ends = rowptr[np.minimum(np.arange(0, n, L1_ROWS) + L1_ROWS, n)]
    max_block_nnz = int((ends - rowptr[0:n:L1_ROWS]).max()) if n else 0

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    return CSRPattern(
        rows=torch.as_tensor(r, device=dev), cols=torch.as_tensor(c, device=dev),
        rowptr=i32(rowptr), col=i32(col), perm=perm, n=int(n),
        n_cols=n_cols,
        tile_ptr=i32(tile_ptr), tile_rows=i32(tile_rows), col_ptr=i32(col_ptr),
        tile_cols=i32(tile_cols),
        slot=torch.as_tensor(slot, dtype=torch.uint8, device=dev),
        row_off=i32(row_off), max_rows=max_rows, max_cols=max_cols, max_nnz=max_nnz,
        max_block_nnz=max_block_nnz, plan_s=time.perf_counter() - t0)


def build() -> str:
    """Compile ``csrc/csr_mv.cu`` (``band_kernel.compile_source``) and load
    it.  Returns the compiler's report of the build."""
    global _lib
    report = compile_source(SOURCE, _LIB_PATH)
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        for regime in REGIMES:
            for dt in ("f64", "f32"):
                fn = getattr(lib, f"csr_mv_{regime.lower()}_{dt}")
                fn.argtypes = [ctypes.c_void_p] * 11 \
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] \
                    + [ctypes.c_int] * 3 + [ctypes.c_longlong] \
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _lib = lib
    return report


# the kernels by lane count: one lane, 2 to 31, and 32 or more
REGIMES = ("L1", "narrow", "wide")


def regime(L: int) -> str:
    """The kernel ``csr_mv_cuda`` launches for L lanes."""
    return "L1" if L == 1 else "narrow" if L < WIDE_LANES else "wide"


def scatter_mv(data, x, rows, cols, n: int, seg: int | None = None):
    """Plain torch y = data x: the (S, nnz) operator stack on the flat
    pattern of n rows applied to (..., n_cols) (any n_cols the columns
    index), output (S, ..., n), by ``index_add`` over the rows.  The nnz
    axis goes in segments of ``seg`` entries (None: one pass), each
    segment's (S, ..., seg) contribution tensor short-lived.
    Out of place, so forward- and reverse-mode AD both run through it."""
    S, nnz = data.shape
    seg = max(1, nnz if seg is None else int(seg))
    bshape = (S,) + (1,) * (x.dim() - 1)
    out = torch.zeros((S,) + x.shape[:-1] + (n,),
                      dtype=torch.promote_types(data.dtype, x.dtype),
                      device=x.device)
    for lo in range(0, nnz, seg):
        contrib = data[:, lo:lo + seg].reshape(bshape + (-1,)) \
            * x[..., cols[lo:lo + seg]][None]
        out = out.index_add(-1, rows[lo:lo + seg], contrib)
    return out


def _check(data, x, csr: CSRPattern) -> None:
    if not isinstance(csr, CSRPattern):
        raise TypeError("csr_mv takes the pattern's CSRPattern (build_csr).")
    if (data.dim() != 2 or data.shape[1] != csr.nnz
            or x.shape[-1] != csr.n_cols):
        raise ValueError(f"shape mismatch: data {tuple(data.shape)}, x "
                         f"{tuple(x.shape)}, pattern of {csr.nnz} nonzeros "
                         f"on {csr.n} x {csr.n_cols}.")


def csr_mv_cuda(data, x, csr: CSRPattern):
    """y = data x through the CUDA kernel: data (S, nnz) f64 or f32 in the
    flat order, x (..., n_cols) of the same dtype, both on the pattern's
    CUDA device; output (S, ..., n).  One launch, of the kernel ``regime``
    picks for L = prod(x.shape[:-1]) lanes, reading x where it lies (its
    strides; a copy only where x cannot be viewed as (L, n_cols))."""
    _check(data, x, csr)
    if data.dtype != x.dtype or x.dtype not in (torch.float64,
                                                torch.float32):
        raise TypeError(f"csr_mv_cuda takes f64 or f32 data and x of one "
                        f"dtype, not {data.dtype} and {x.dtype}.")
    if not (x.is_cuda and data.device == x.device == csr.col.device):
        raise ValueError("csr_mv_cuda needs data, x and the pattern on one "
                         "CUDA device.")
    if _lib is None:
        build()
    S, n = data.shape[0], csr.n
    lead = x.shape[:-1]
    L = math.prod(lead)
    y = torch.empty((S, L, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:   # nothing to launch
        return y.reshape((S,) + lead + (n,))
    d = data if data.is_contiguous() else data.contiguous()
    kind = regime(L)
    x2 = x.reshape(L, csr.n_cols)
    sxl, sxc = x2.stride()
    fn = getattr(_lib, f"csr_mv_{kind.lower()}_"
                       f"{'f64' if x.dtype == torch.float64 else 'f32'}")
    args = (d.data_ptr(), csr.tile_ptr.data_ptr(), csr.tile_rows.data_ptr(),
            csr.col_ptr.data_ptr(), csr.tile_cols.data_ptr(),
            csr.slot.data_ptr(), csr.row_off.data_ptr(),
            csr.rowptr.data_ptr(), csr.col.data_ptr(),
            0 if csr.perm is None else csr.perm.data_ptr(), x2.data_ptr(), sxl,
            sxc, y.data_ptr(), S, L, n, csr.nnz, csr.n_tiles, csr.max_rows,
            csr.max_cols, csr.max_nnz, csr.max_block_nnz)
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc < 0:
        raise RuntimeError(f"csr_mv kernel launch failed: cudaError {-rc}.")
    csr_mv_cuda.launches += rc
    csr_mv_cuda.launches_by_regime[kind] += rc
    return y.reshape((S,) + lead + (n,))


csr_mv_cuda.launches = 0
csr_mv_cuda.launches_by_regime = dict.fromkeys(REGIMES, 0)


def reset_launches() -> None:
    """Set ``csr_mv_cuda``'s launch counts to 0."""
    csr_mv_cuda.launches = 0
    csr_mv_cuda.launches_by_regime = dict.fromkeys(REGIMES, 0)


def csr_mv_reference(data, x, csr: CSRPattern, seg: int | None = None):
    """The plain version of ``csr_mv_cuda`` (``scatter_mv`` on the flat
    pattern)."""
    _check(data, x, csr)
    return scatter_mv(data, x, csr.rows, csr.cols, csr.n, seg)


def csr_mv(data, x, csr: CSRPattern, seg: int | None = None):
    """The flat-pattern operator stack applied to (..., n): the CUDA kernel
    for a CUDA tensor, its plain torch version for a CPU tensor (``seg``:
    the plain version's nnz segment).  Not differentiable: ``csr_apply``
    is."""
    if x.is_cuda:
        return csr_mv_cuda(data, x, csr)
    return csr_mv_reference(data, x, csr, seg)


_X_CONSTANT = ("csr_apply is differentiable in x only with the transposed "
               "pattern's plan (csr_t); without it x is a constant of the "
               "residual map.")


def _data_grad(gy, x, csr: CSRPattern, seg: int | None):
    """d<gy, data x>/d data: sum over the lanes of gy at each entry's row
    times x at its column, (S, nnz), nnz in segments of ``seg`` — a gather
    and a reduction, no scatter."""
    S, n, nnz = gy.shape[0], csr.n, csr.nnz
    seg = max(1, nnz if seg is None else int(seg))
    g2 = gy.reshape(S, -1, n)
    x2 = x.reshape(-1, csr.n_cols).to(gy.dtype)
    return torch.cat([
        torch.einsum("sln,ln->sn", g2[..., csr.rows[lo:lo + seg]],
                     x2[:, csr.cols[lo:lo + seg]])
        for lo in range(0, nnz, seg)], dim=1)


class CSRMatVec(torch.autograd.Function):
    """``csr_mv(data, x, csr, seg)`` differentiable in ``data`` by forward
    and reverse mode, under ``torch.func`` transforms too (``jacfwd`` =
    vmap of jvp).  Without ``csr_t`` x is a constant of every path (the
    residual map's fixed U): a derivative in x, or a batch of x under
    vmap, raises.  With ``csr_t``, the plan of the transposed pattern
    (``build_csr(cols, rows, n_cols, n)``), x is differentiable too: the
    cotangent of x is the transposed stack applied to the output's
    cotangent, one K3 product per operator through this Function (so a
    backward is itself differentiable); the sparse API's ``matvec`` runs
    on it."""

    @staticmethod
    def forward(data, x, csr, seg, csr_t=None):
        return csr_mv(data, x, csr, seg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, x, csr, seg = inputs[:4]
        ctx.csr, ctx.seg = csr, seg
        ctx.csr_t = inputs[4] if len(inputs) > 4 else None
        ctx.save_for_backward(data, x)
        ctx.save_for_forward(data, x)
        # an input without a tangent gets None, not a tensor of zeros (one
        # K3 product on zeros in every jvp otherwise)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gy):
        data, x = ctx.saved_tensors
        if ctx.needs_input_grad[1] and ctx.csr_t is None:
            raise NotImplementedError(_X_CONSTANT)
        if gy is None:
            return None, None, None, None, None
        gd = (_data_grad(gy, x, ctx.csr, ctx.seg)
              if ctx.needs_input_grad[0] else None)
        gx = None
        if ctx.needs_input_grad[1]:
            gx = sum(CSRMatVec.apply(data[s:s + 1], gy[s], ctx.csr_t,
                                     ctx.seg, ctx.csr)[0]
                     for s in range(data.shape[0]))
        return gd, gx, None, None, None

    @staticmethod
    def jvp(ctx, d_data, d_x, _csr, _seg, _csr_t=None):
        if d_x is not None and ctx.csr_t is None:
            raise NotImplementedError(_X_CONSTANT)
        data, x = ctx.saved_tensors
        out = None
        if d_data is not None:
            out = CSRMatVec.apply(d_data, x, ctx.csr, ctx.seg, ctx.csr_t)
        if d_x is not None:
            dx = CSRMatVec.apply(data, d_x, ctx.csr, ctx.seg, ctx.csr_t)
            out = dx if out is None else out + dx
        return out

    @staticmethod
    def vmap(info, in_dims, data, x, csr, seg, csr_t=None):
        if in_dims[1] is not None and csr_t is None:
            raise NotImplementedError(_X_CONSTANT)
        if in_dims[1] is None:
            # batched data (the tangents of jacfwd): fold the batch into
            # the operator stack, one product for all of them
            data = data.movedim(in_dims[0], 0)
            B, S = data.shape[:2]
            out = CSRMatVec.apply(data.reshape(B * S, -1), x, csr, seg,
                                  csr_t)
            return out.reshape((B, S) + out.shape[1:]), 0
        x = x.movedim(in_dims[1], 0)
        if in_dims[0] is None:
            # a batch of x: more lanes of one product
            return CSRMatVec.apply(data, x, csr, seg, csr_t), 1
        data = data.movedim(in_dims[0], 0)
        return torch.stack([CSRMatVec.apply(d, xb, csr, seg, csr_t)
                            for d, xb in zip(data, x)]), 0


def csr_apply(data, x, csr: CSRPattern, seg: int | None = None,
              csr_t: CSRPattern | None = None):
    """Differentiable ``csr_mv`` (``CSRMatVec``): the residual map's
    operator apply (in the data only), or with ``csr_t`` a product
    differentiable in x too."""
    return CSRMatVec.apply(data, x, csr, seg, csr_t)
