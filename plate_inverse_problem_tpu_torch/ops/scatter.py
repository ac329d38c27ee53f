"""Flat-pattern sparse ops (port of the JAX package's ``ops/scatter.py``).

Every FEM matrix is flat nonzero data over one static (row, col) pattern.
``spmv_flat`` gathers ``x`` at the columns and scatter-adds into the rows
with ``index_add_`` along the last axis; ``to_dense`` scatters the data
into a dense matrix.  On CUDA an ``index_add_`` sums with atomics in no
fixed order, so results carry run-to-run last-bit noise (far below the
1e-6 FRF gate).
"""
from __future__ import annotations

import torch


def to_dense(data, rows, cols, n: int):
    """Scatter flat COO data into a dense (n, n) matrix (duplicates add)."""
    out = torch.zeros(n * n, dtype=data.dtype, device=data.device)
    return out.index_add_(0, rows * n + cols, data).reshape(n, n)


def spmv_flat(data, rows, cols, x, n: int, transpose: bool = False):
    """y = A @ x with A given as flat COO data; x may be batched (..., n).

    ``transpose=True`` computes A^T @ x by swapping the index roles.
    """
    r, c = (cols, rows) if transpose else (rows, cols)
    contrib = data * x[..., c]
    out = torch.zeros(x.shape[:-1] + (n,), dtype=contrib.dtype,
                      device=x.device)
    return out.index_add_(-1, r, contrib)
