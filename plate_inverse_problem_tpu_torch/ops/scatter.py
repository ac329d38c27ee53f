"""Flat-pattern sparse ops (port of the JAX package's ``ops/scatter.py``).

Every FEM matrix is flat nonzero data over one static (row, col) pattern.
``to_dense`` scatters the data into a dense matrix (each slot once, so the
same bits on any device).  The products on the pattern (the JAX package's
``spmv_flat``) run K3, the CSR kernel of ``ops/csr_kernel.py``, which sums
every row in one fixed order on the card; its plain version there,
``scatter_mv``, is the ``index_add_`` matvec used on the CPU.
"""
from __future__ import annotations

import torch


def to_dense(data, rows, cols, n: int):
    """Scatter flat COO data into a dense (n, n) matrix (duplicates add)."""
    out = torch.zeros(n * n, dtype=data.dtype, device=data.device)
    return out.index_add_(0, rows * n + cols, data).reshape(n, n)
