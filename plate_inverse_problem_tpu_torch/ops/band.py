"""Block-tridiagonal banded operator application (port of ``ops/band.py``).

1. Reverse-Cuthill-McKee reorders the free DOFs; a 2D plate mesh then has
   bandwidth O(sqrt(n)).
2. With block size b >= bandwidth the matrix is block-TRIDIAGONAL in dense
   (b, b) blocks: y_q = A_{q,0} x_{q-1} + A_{q,1} x_q + A_{q,2} x_{q+1},
   stored as one (nb, b, 3b) tensor.
3. Operator application is one batched GEMM over the (B, nb, 3b) windows of
   x.  The f64 apply stays a batched ``einsum`` (cuBLAS DGEMM); the f32
   apply of the preconditioner is the hand-written CUDA kernel of
   ``ops/band_kernel.py``.

The host-side layout code (band layout, rectangular prolongation layout,
permutations) is a numpy copy of the JAX package's.  The JAX side's f64 block-axis
segmentation is a TPU memory workaround and is not ported.

The rectangular prolongation's products (``rect_band_mv``,
``rect_band_tmv``) run one batched GEMM a fixed group of block rows
(``dense.fixed_blocks(nb, 1)``, at most 8 groups), each group's operands
contiguous in block-row-major (q, lanes, .) layout and its product
written in place: a dof rank that owns whole groups
(``rect_band_mv_rows``, ``restrict_windows``) makes the same calls on its
block rows, so its rows carry the whole product's bits.  One batched GEMM
over all block rows would not: cuBLAS picks its kernel by the batch count
too, and a rank's block rows then round otherwise at up to 16 lanes (the
21k plate on the H100, ``.probes/twogrid_cost_probe.py --bits``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .dense import blocks_within, fixed_blocks


@dataclass(frozen=True)
class BandLayout:
    """Static metadata of the block-tridiagonal layout (host-built).

    ``perm``: free-DOF relabeling (new index i holds old DOF perm[i]);
    ``lin``: flat scatter targets mapping pattern entry s into the
    (nb, 3, b, b) block tensor (already in permuted row/col space).
    """
    n: int
    b: int
    nb: int
    bandwidth: int
    perm: np.ndarray = field(repr=False)
    iperm: np.ndarray = field(repr=False)
    lin: np.ndarray = field(repr=False)


def build_band_layout(rows, cols, n: int, block_multiple: int = 128,
                      min_block: int = 256) -> BandLayout:
    """RCM-reorder the pattern and lay it out block-tridiagonally.

    Host-side, called once per Problem.  ``lin`` assumes the caller will
    relabel its pattern to ``iperm[rows], iperm[cols]`` (the mixed engine
    does this for all operator data and n-vectors).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    A = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(A + A.T, symmetric_mode=True),
                      dtype=np.int64)
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    rp = iperm[rows]
    cp = iperm[cols]
    bw = int(np.abs(rp - cp).max()) if rows.size else 0

    b = max(min_block, -(-bw // block_multiple) * block_multiple)
    nb = -(-n // b)
    q = rp // b
    d = cp // b - q + 1
    if d.min() < 0 or d.max() > 2:  # cannot happen for b >= bw
        raise ValueError("pattern is not block-tridiagonal at this block size")
    # (q, i_loc, d, j_loc) layout — the tensor is stored (nb, b, 3b), the
    # exact operand shape of the batched GEMM in band_mv
    lin = ((q * b + rp % b) * 3 + d) * b + cp % b
    idt = np.int32 if lin.max() < 2**31 else np.int64
    return BandLayout(n=n, b=b, nb=nb, bandwidth=bw, perm=perm, iperm=iperm,
                      lin=lin.astype(idt))


def flat_to_band(vals, layout: BandLayout, lin):
    """Scatter flat pattern data (possibly stacked (..., nnz)) into the
    (..., nb, b, 3b) block tensor.  ``lin`` is the layout's index tensor on
    the device of ``vals``."""
    lead = vals.shape[:-1]
    nb, b = layout.nb, layout.b
    flat = torch.zeros(lead + (nb * 3 * b * b,), dtype=vals.dtype,
                       device=vals.device)
    flat.index_add_(-1, lin, vals)
    return flat.reshape(lead + (nb, b, 3 * b))


def band_mv(band, x, layout: BandLayout):
    """y = A x for block-tridiagonal ``band`` (nb, b, 3b); x (..., n).

    The zero-padded [x_{q-1} | x_q | x_{q+1}] windows of every block row,
    then one batched GEMM ``(q,i,c) x (B,q,c) -> (B,q,i)`` in the dtype of
    the operands (f64: cuBLAS DGEMM; f32 only in the tests, as the dense
    reference of the packed f32 apply of ops/band_kernel.py)."""
    n, b, nb = layout.n, layout.b, layout.nb
    lead = x.shape[:-1]
    xf = x.reshape(-1, n)
    B = xf.shape[0]
    xb = torch.nn.functional.pad(xf, (0, nb * b - n)).reshape(B, nb, b)
    xm = torch.nn.functional.pad(xb, (0, 0, 1, 1))
    xn = torch.stack([xm[:, :-2, :], xm[:, 1:-1, :], xm[:, 2:, :]], dim=-2)
    y = torch.einsum("qic,Bqc->Bqi", band, xn.reshape(B, nb, 3 * b))
    return y.reshape(lead + (nb * b,))[..., :n]


@dataclass(frozen=True)
class RectBandLayout:
    """Rectangular block-band layout for a prolongation P (fine x coarse).

    The coarse DOFs are relabeled by the *induced* order (sorted by the
    mean fine-RCM row of their P column), then partitioned into the SAME
    number of blocks as the fine band layout (block size ``bc``).  Every
    column then only touches fine blocks within ``hw`` block offsets, so
    prolongation and restriction are single batched f32 GEMMs over the
    (nb, b, nd*bc) tensor — no scatter, no gather.
    """
    n_fine: int
    n_coarse: int
    nb: int
    b: int
    bc: int
    nd: int        # number of block diagonals (2*hw + 1)
    hw: int
    perm_c: np.ndarray = field(repr=False)   # induced coarse relabeling
    slots: np.ndarray = field(repr=False)    # compact index -> padded slot
    lin: np.ndarray = field(repr=False)      # scatter targets into the tensor
    vals: np.ndarray = field(repr=False)     # P entries (induced order)


def build_rect_band(P_csr, layout: BandLayout,
                    bc_multiple: int = 128) -> RectBandLayout:
    """Lay out a (permuted-row-space) prolongation as rectangular block-band.

    ``P_csr`` rows must already be in the fine layout's RCM order.  Returns
    the layout plus flat (vals, lin) so callers can build the tensor on
    device (transfers stay a few MB).
    """
    import scipy.sparse as sp

    P = sp.coo_matrix(P_csr)
    n_f, n_c = P.shape
    nb, b = layout.nb, layout.b

    # each coarse column is assigned to the fine BLOCK holding the mean of
    # its support rows (a uniform slot->block mapping fails badly when the
    # coarse density varies along the fine RCM axis — measured 189 block
    # diagonals vs 3-5 with target-block assignment); block capacity is
    # the largest bucket, rounded up to the lane multiple
    colsum = np.zeros(n_c)
    colcnt = np.zeros(n_c)
    np.add.at(colsum, P.col, P.row.astype(np.float64))
    np.add.at(colcnt, P.col, 1.0)
    key = np.where(colcnt > 0, colsum / np.maximum(colcnt, 1.0), 0.0)
    target = np.clip((key // b).astype(np.int64), 0, nb - 1)
    order = np.lexsort((key, target))              # group by block, local order
    perm_c = order.astype(np.int64)
    rank = np.empty(n_c, np.int64)
    # rank within each target block
    tgt_sorted = target[order]
    starts = np.searchsorted(tgt_sorted, np.arange(nb))
    rank[order] = np.arange(n_c) - starts[tgt_sorted]

    counts = np.bincount(target, minlength=nb)
    bc = max(bc_multiple,
             -(-int(counts.max()) // bc_multiple) * bc_multiple)
    slot = target * bc + rank
    q = P.row // b
    qc = target[P.col]
    hw = int(np.abs(qc - q).max()) if P.nnz else 0
    nd = 2 * hw + 1
    lin = ((q * nd + (qc - q + hw)) * b + P.row % b) * bc + slot[P.col] % bc
    idt = np.int32 if lin.max() < 2**31 else np.int64
    return RectBandLayout(n_fine=n_f, n_coarse=n_c, nb=nb, b=b, bc=bc,
                          nd=nd, hw=hw, perm_c=perm_c,
                          slots=slot[perm_c].astype(np.int32),
                          lin=lin.astype(idt),
                          vals=P.data.astype(np.float32))


def rect_band_tensor(rl: RectBandLayout, device):
    """(nb, b, nd*bc) f32 prolongation tensor built on ``device``."""
    flat = torch.zeros(rl.nb * rl.nd * rl.b * rl.bc, dtype=torch.float32,
                       device=device)
    flat.index_add_(0, torch.as_tensor(rl.lin, dtype=torch.int64,
                                       device=device),
                    torch.as_tensor(rl.vals, device=device))
    return flat.reshape(rl.nb, rl.nd, rl.b, rl.bc).permute(0, 2, 1, 3) \
        .reshape(rl.nb, rl.b, rl.nd * rl.bc)


def _group_bmm(a, b, q0: int, nb: int):
    """(q, B, j): ``torch.bmm(a, b)`` over block rows [q0, q0 + q) of a
    band of nb, a (q, B, k) and b (q, k, j), one call a fixed group of
    block rows (``fixed_blocks(nb, 1)``; the rows must start and end on
    group bounds), each written in place."""
    q = a.shape[0]
    out = a.new_empty((q, a.shape[1], b.shape[2]))
    for g0, g1 in blocks_within(fixed_blocks(nb, 1), q0, q0 + q):
        torch.bmm(a[g0 - q0:g1 - q0], b[g0 - q0:g1 - q0],
                  out=out[g0 - q0:g1 - q0])
    return out


def _coarse_windows(rl: RectBandLayout, xc, slots, q0: int, q1: int):
    """(q1 - q0, B, nd*bc): the padded-slot windows of block rows [q0, q1)
    of compact coarse (..., n_c) rows, block-row major."""
    xcf = xc.reshape(-1, rl.n_coarse)
    B = xcf.shape[0]
    xs = torch.zeros(B, rl.nb * rl.bc, dtype=xc.dtype, device=xc.device)
    xs[:, slots] = xcf
    xm = torch.nn.functional.pad(xs.reshape(B, rl.nb, rl.bc).transpose(0, 1),
                                 (0, 0, 0, 0, rl.hw, rl.hw))
    win = torch.stack([xm[q0 + d:q1 + d] for d in range(rl.nd)], dim=2)
    return win.reshape(q1 - q0, B, rl.nd * rl.bc)


def rect_band_mv(Pt, xc, rl: RectBandLayout, slots):
    """Prolongation y_f = P x_c, a batched GEMM a fixed group of block rows;
    xc (..., n_c) compact.  ``slots`` maps compact coarse indices into the
    padded block-slot space."""
    return rect_band_mv_rows(Pt, xc, rl, slots, 0)


def rect_band_mv_rows(Pt_rows, xc, rl: RectBandLayout, slots, q0: int):
    """Rows [q0 b, min(n_fine, q1 b)) of the prolongation P x_c from block
    rows [q0, q1) of P (``Pt_rows``, a dof rank's), the whole product's
    bits; xc (..., n_c) compact, whole."""
    lead = xc.shape[:-1]
    q1 = q0 + Pt_rows.shape[0]
    win = _coarse_windows(rl, xc, slots, q0, q1)
    y = _group_bmm(win, Pt_rows.transpose(1, 2), q0, rl.nb)   # (q, B, b)
    rows = min(rl.n_fine, q1 * rl.b) - q0 * rl.b
    return y.transpose(0, 1).reshape(lead + ((q1 - q0) * rl.b,))[..., :rows]


def restrict_windows(Pt_rows, rf_rows, rl: RectBandLayout, q0: int):
    """The restriction's window terms w (B, q1 - q0, nd, bc) = P_q^T r_q of
    block rows [q0, q1) (a block-row-major view): ``rf_rows`` (..., rows
    [q0 b, min(n_fine, q1 b))) of the fine residual, flattened to B
    lanes."""
    q1 = q0 + Pt_rows.shape[0]
    rows = min(rl.n_fine, q1 * rl.b) - q0 * rl.b
    rp = torch.nn.functional.pad(rf_rows.reshape(-1, rows),
                                 (0, (q1 - q0) * rl.b - rows))
    B = rp.shape[0]
    rq = rp.reshape(B, q1 - q0, rl.b).transpose(0, 1).contiguous()
    w = _group_bmm(rq, Pt_rows, q0, rl.nb)                 # (q, B, nd*bc)
    return w.reshape(q1 - q0, B, rl.nd, rl.bc).transpose(0, 1)


def fold_windows(w, w_lo: int, q0: int, q1: int, rl: RectBandLayout):
    """The padded coarse slots (B, q1 - q0, bc) of coarse blocks [q0, q1):
    block qc is the sum over d of the window terms w[qc + hw - d, d] that
    exist, added to zero in d order (the whole restriction's order).  ``w``
    (B, *, nd, bc) holds the terms of block rows [w_lo, w_lo +
    w.shape[1])."""
    hw, w_hi = rl.hw, w_lo + w.shape[1]
    acc = torch.zeros(w.shape[0], q1 - q0, rl.bc, dtype=w.dtype,
                      device=w.device)
    for d in range(rl.nd):
        a, b = max(q0, w_lo - hw + d), min(q1, w_hi - hw + d)
        if a < b:
            acc[:, a - q0:b - q0] += w[:, a + hw - d - w_lo:
                                       b + hw - d - w_lo, d]
    return acc


def rect_band_tmv(Pt, rf, rl: RectBandLayout, slots):
    """Restriction r_c = P^T r_f — the transposed GEMMs (one a fixed group
    of block rows) plus a fold of the overlapping block windows back onto
    the padded slots (nd shifted adds), then the compact gather."""
    lead = rf.shape[:-1]
    w = restrict_windows(Pt, rf, rl, 0)
    acc = fold_windows(w, 0, 0, rl.nb, rl).reshape(w.shape[0], -1)
    return acc[:, slots].reshape(lead + (rl.n_coarse,))


def permute_pattern(layout: BandLayout, rows, cols):
    """Relabel pattern indices into the RCM ordering (host-side)."""
    return (layout.iperm[np.asarray(rows)].astype(np.int32),
            layout.iperm[np.asarray(cols)].astype(np.int32))


def permute_vector(layout: BandLayout, v, axis: int = -1):
    """Relabel an n-vector (or a stack of them along ``axis``) into the RCM
    ordering: entry i of the result is old entry perm[i] (host-side)."""
    return np.take(np.asarray(v), layout.perm, axis=axis)
