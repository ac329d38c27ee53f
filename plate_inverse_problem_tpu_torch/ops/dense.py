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
"""
from __future__ import annotations

import torch


def inv_refined(A):
    """Inverse of a symmetric positive definite matrix ``A`` in ``A``'s
    dtype: symmetric Jacobi equilibration (the scaled matrix's kappa drops
    to the operator's intrinsic spread), one f64 LU inverse, scaled back."""
    d = torch.diagonal(A).double()
    s = 1.0 / torch.sqrt(torch.where(d.abs() > 0, d.abs(),
                                     torch.ones_like(d)))
    X = torch.linalg.inv(A.double() * s[:, None] * s[None, :])
    return (X * s[None, :] * s[:, None]).to(A.dtype)


def dense_apply(inv, x):
    """A dense inverse applied to every row of (..., n), x @ inv.T, in
    inv's dtype: one GEMM (f64: DGEMM; f32: SGEMM, IEEE f32 with TF32 off,
    config.py), or for an inverse row-partitioned over a mesh's dof axis
    (``parallel.freq_shard.RowShard``) this rank's column block and the
    dof group's all_reduce."""
    x = x.to(inv.dtype)
    if isinstance(inv, torch.Tensor):
        return torch.matmul(x, inv.T)
    return inv.apply_t(x)
