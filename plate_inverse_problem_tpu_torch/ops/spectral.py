"""Generalized symmetric eigendecomposition K z = lam M z (port of the JAX
package's ``ops/spectral.py``): the basis of the modal engine
(``ops/sweep.py``), computed once per parameter set, which diagonalises
every A(omega) = (1 + i beta) K - omega^2 M of a sweep at once.

Only the LAPACK route is ported (``torch.linalg`` in f64: LAPACK on the
CPU, cuSOLVER on the card).  The JAX package's block-Jacobi solver
(``method="jacobi"``, its ``ops/jacobi_eigh.py``) works around the TPU's
eigh compile times and is on ROADMAP's "do not port" list.
"""
from __future__ import annotations

import torch

from .scatter import to_dense


def generalized_eigh(K, M):
    """(lam, Z) with K Z = M Z diag(lam) and Z^T M Z = I (K symmetric, M
    symmetric positive definite), by Cholesky reduction: M = L L^T,
    C = L^-1 K L^-T, eigh(C) = (lam, Q), Z = L^-T Q."""
    L = torch.linalg.cholesky(M)
    Y = torch.linalg.solve_triangular(L, K, upper=False)
    C = torch.linalg.solve_triangular(L, Y.T, upper=False).T
    C = 0.5 * (C + C.T)   # roundoff asymmetry out before eigh
    lam, Q = torch.linalg.eigh(C)
    Z = torch.linalg.solve_triangular(L.T, Q, upper=True)
    return lam, Z


def modal_basis_from_flat(K_flat_real, M_flat, rows, cols, n: int,
                          method: str = "lapack"):
    """Eigenbasis (lam (n,), Z (n, n)) of the real part of the flat
    stiffness against the mass, both f64 data on the pattern (rows, cols).

    The basis is numerical data that applies A^-1 exactly: it is computed
    outside autograd, and parameter derivatives flow through the sweep's
    implicit rule, never through eigh (unstable where eigenvalues cross as
    an optimizer moves theta)."""
    if method == "jacobi":
        raise ValueError(
            "method='jacobi' (the JAX package's block-Jacobi eigh, a TPU "
            "workaround) is on ROADMAP's 'do not port' list; use "
            "method='lapack'.")
    if method != "lapack":
        raise ValueError(f"Unknown eigh method {method!r}; the port has "
                         "'lapack'.")
    with torch.no_grad():
        Kr = to_dense(K_flat_real.detach().to(torch.float64), rows, cols,
                      n)
        Md = to_dense(M_flat.detach().to(torch.float64), rows, cols, n)
        Kr = 0.5 * (Kr + Kr.T)
        Md = 0.5 * (Md + Md.T)
        return generalized_eigh(Kr, Md)
