"""Dense inverse of the equilibrated reference stiffness (port of the JAX
package's ``ops/dense.py`` ``inv_refined``), the dense tier's complement
preconditioner.

The JAX package inverts in f32 (the TPU has no f64 LU), polishes with three
f32 Newton-Schulz steps X <- X (2I - A X) and applies the inverse in f32
with one f32 refinement round.  That needs eps32 * kappa well below 1.
The equilibrated plate stiffness has kappa 6.7e6 at 1466 DOF and 7.6e7 at
5428, so from a few thousand DOF the f32 inverse is good or bad by the
luck of its rounding, and where it is bad FGMRES stalls in the stiff
directions (sh_i, "auto", bench.py's 4 points, against an f64 splu, on
the CPU: the JAX package itself 5.6e-10 at n = 5428, 2.5e-3 at 8568,
6.3e-3 at 11910; the same algorithm on torch's f32 LU 1.1e-4 at 5428,
max |A X - I| 0.66-1.99 from there on; .probes/dense_tier_accuracy.py).
The card has IEEE f64 LU and f64 tensor-core GEMMs as fast as its f32
ones, so the port inverts and applies in f64 (1.1e-8 at 11910, the same
probe).  ``inv_blocked``, the JAX package's way around the TPU's LU panel
limit, is not needed: one ``torch.linalg.inv`` takes any n of the dense
tier (n <= 12288).

The inverse is applied by fixed row blocks (``fixed_blocks``): at most 8
blocks of whole 64-row units, their bounds a function of n only, one GEMM
each.  A rank of a dof mesh owns whole blocks of the inverse
(``parallel.freq_shard.RowShard``) and runs the same GEMMs on them, so
every output column has the same reduction, and the same bits, whether the
inverse is whole or split over ranks.
"""
from __future__ import annotations

import torch

# the most blocks an inverse's rows (or a band's block rows) are cut into,
# and the dense inverses' row unit
MAX_BLOCKS = 8
ROW_UNIT = 64


def fixed_blocks(length: int, unit: int = ROW_UNIT) -> list[int]:
    """Bounds [0, ..., length] of at most ``MAX_BLOCKS`` blocks of whole
    ``unit``s (the last one cut at ``length``), as even as the units allow;
    a function of ``length`` and ``unit`` only."""
    units = -(-length // unit)
    g = min(MAX_BLOCKS, units)
    return [min(length, k * units // g * unit) for k in range(g + 1)]


def owned_blocks(bounds: list[int], n_dof: int, i_dof: int) -> tuple:
    """[lo, hi): the whole blocks of ``bounds`` that rank ``i_dof`` of a dof
    axis of ``n_dof`` owns, split as evenly as the blocks allow (a rank
    may own none where there are fewer blocks than ranks)."""
    g = len(bounds) - 1
    return bounds[i_dof * g // n_dof], bounds[(i_dof + 1) * g // n_dof]


def inv_refined(A):
    """Inverse of a symmetric positive definite matrix ``A`` in ``A``'s
    dtype: symmetric Jacobi equilibration (the scaled matrix's kappa drops
    to the operator's intrinsic spread), one f64 LU inverse, scaled back.
    Row-major: LAPACK's column-major inverse is taken transposed (the
    inverse of the symmetric A^T = A), so a block of its rows is
    contiguous, the layout a rank's owned copy of it has."""
    d = torch.diagonal(A).double()
    s = 1.0 / torch.sqrt(torch.where(d.abs() > 0, d.abs(),
                                     torch.ones_like(d)))
    X = torch.linalg.inv(A.double() * s[:, None] * s[None, :])
    if not X.is_contiguous():
        X = X.mT
    return (X * s[None, :] * s[:, None]).to(A.dtype)


def blocks_within(bounds: list[int], lo: int, hi: int) -> list[tuple]:
    """The blocks [a, c) of ``bounds`` that make up [lo, hi), which must
    start and end on its bounds (none where lo == hi)."""
    b = [r for r in bounds if lo <= r <= hi]
    if lo < hi and (b[0] != lo or b[-1] != hi):
        raise ValueError(f"[{lo}, {hi}) does not start and end on the fixed "
                         f"blocks {bounds}")
    return list(zip(b, b[1:]))


def blocked_matmul(x, rows, lo: int, n: int):
    """x @ rows.T for ``rows``, rows [lo, lo + len(rows)) of an (n, m)
    matrix that start and end on its ``fixed_blocks(n)``: one GEMM a
    block, joined along the last axis."""
    return torch.cat([torch.matmul(x, rows[a - lo:c - lo].T) for a, c in
                      blocks_within(fixed_blocks(n), lo, lo + rows.shape[0])]
                     or [x.new_zeros(x.shape[:-1] + (0,))], -1)


def dense_apply(inv, x):
    """A dense inverse applied to every row of (..., n), x @ inv.T, in
    inv's dtype: one GEMM a fixed row block of the inverse
    (``blocked_matmul``; f64: DGEMM; f32: SGEMM, IEEE f32 with TF32 off,
    config.py), or for an inverse row-partitioned over a mesh's dof axis
    (``parallel.freq_shard.RowShard``) the same GEMMs on this rank's blocks
    and the dof group's all_reduce."""
    x = x.to(inv.dtype)
    if isinstance(inv, torch.Tensor):
        return blocked_matmul(x, inv, 0, inv.shape[0])
    return inv.apply_t(x)
