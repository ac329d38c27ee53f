"""Flat-pattern sparse ops (port of the JAX package's ``ops/scatter.py``).

Every FEM matrix is flat nonzero data over one static (row, col) pattern.
``to_dense`` scatters the data into a dense matrix (each slot once, so the
same bits on any device).  The products on the pattern (the JAX package's
``spmv_flat``) run K3, the CSR kernel of ``ops/csr_kernel.py``, which sums
every row in one fixed order on the card; its plain version there,
``scatter_mv``, is the ``index_add_`` matvec used on the CPU.
``spmv_flat`` is that product with the JAX function's signature.
"""
from __future__ import annotations

import torch


def to_dense(data, rows, cols, n: int):
    """Dense (..., n, n) matrices from flat data (..., nnz) on the pattern
    (rows, cols) (JAX ``to_dense``, which takes one matrix and adds
    repeated pairs): each slot is assigned once, with no accumulation and so
    no atomics on the card.  Precondition: the (row, col) pairs are unique,
    as on every assembled pattern (K3's CSR plan relies on it too); a
    repeated pair would keep one of its values, not their sum."""
    lead = data.shape[:-1]
    out = torch.zeros(lead + (n * n,), dtype=data.dtype, device=data.device)
    out[..., rows * n + cols] = data
    return out.reshape(lead + (n, n))


def spmv_flat(data, rows, cols, x, n: int, transpose: bool = False):
    """y = A x for A given as flat data (nnz,) on the pattern (rows, cols),
    x (..., n_cols) (JAX ``ops/scatter.py`` ``spmv_flat``); ``transpose``
    gives A^T x, on the swapped pattern's plan.  One K3 product
    (``csr_kernel.csr_apply``): the CUDA kernel for a CUDA tensor, its
    plain version on the CPU, differentiable in ``data``.

    Differs from the JAX function: it builds the pattern's K3 plan in
    every call (the sweeps keep theirs: ``build_csr`` once per
    ``getFRCore``), x's last axis gives the columns, and on the card data
    and x must have one dtype (f64 or f32).  A repeated (row, col) pair
    adds, as in the JAX scatter."""
    from .csr_kernel import build_csr, csr_apply

    r, c = (cols, rows) if transpose else (rows, cols)
    csr = build_csr(torch.as_tensor(r, device=x.device).long(),
                    torch.as_tensor(c, device=x.device).long(), n,
                    x.shape[-1])
    return csr_apply(data[None], x, csr)[0]
