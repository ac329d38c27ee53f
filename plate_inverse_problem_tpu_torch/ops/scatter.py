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
    """Dense (..., n, n) matrices from flat data (..., nnz) on the pattern
    (rows, cols): each slot is assigned once, with no accumulation and so
    no atomics on the card.  Precondition: the (row, col) pairs are unique,
    as on every assembled pattern (K3's CSR plan relies on it too); a
    repeated pair would keep one of its values, not their sum."""
    lead = data.shape[:-1]
    out = torch.zeros(lead + (n * n,), dtype=data.dtype, device=data.device)
    out[..., rows * n + cols] = data
    return out.reshape(lead + (n, n))
