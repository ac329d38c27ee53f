"""Standalone sparse linear-algebra API over a static sparsity pattern (port
of the JAX package's ``ops/sparse_api.py``).

The reference exposes its solver bridge as three primitives that work on ANY
square CSC system, independent of the plate pipeline: ``create_symbolic`` /
``spsolve`` / ``matvec`` (reference Sparse.py:92-116, 144-236, backed by the
UMFPACK ``InnerState`` C++ registry).  Here:

* ``create_symbolic(N, indices, dtype)`` canonicalizes the pattern on the
  host exactly like the reference (CSC entry order, duplicates merged) and
  returns the canonical ``(row, col)`` plus a hashable
  :class:`SymbolicPattern` that plays the role of the reference's
  ``solver_num`` registry handle — plain host data, nothing process-global.
* ``matvec(pattern, data, vec)`` is one launch of the CSR kernel (K3,
  ops/csr_kernel.py) on the pattern's plan, built once per device and
  kept with the pattern: every output summed in one fixed order, the same
  bits in every call.  The transpose runs on the swapped pattern's plan,
  over the same data.  Complex data goes as its (re, im) parts, an S = 2
  operator stack applied to the (re, im) lanes of ``vec`` in the same
  launch.  It is differentiable in ``data`` and ``vec`` through K3's
  autograd Function.
* ``spsolve(pattern, data, b)`` solves ``A x = b``: densify (``to_dense``)
  and factor natively in f64 / complex128 (``torch.linalg.lu_factor``, one
  matrix a call), then ``refine_steps`` rounds of refinement against K3's
  product.  The JAX package factors in the 32-bit twin dtype on its TPU
  and refines against a split-f64 product; the card has IEEE f64 LU, so
  that path is gone.  Its derivatives are the reference's adjoint rules
  (Sparse.py:200-222) in a ``torch.autograd.Function``: one transposed
  solve for the cotangent of ``b``, the pattern-restricted outer product
  for ``data``, the forward mode one solve of the tangent system; the
  backward runs through the Function itself, so it is differentiable again
  (Hessians), and a ``vmap`` rule batches right-hand sides into one
  factorization and batched matrices into one factorization each (the
  reference's batch modes 0-4, Sparse.py:238-282).
"""
from __future__ import annotations

import numpy as np
import torch

from .csr_kernel import build_csr, csr_apply
from .scatter import to_dense

__all__ = ["SymbolicPattern", "create_symbolic", "find_permutation",
           "matvec", "spsolve", "FAMILIES"]

# dtype families accepted by the reference bridge (Sparse.py:87-90); index
# width is immaterial here (patterns are host numpy), kept for parity checks
FAMILIES = {
    (np.dtype(np.float64), np.dtype(np.int32)): "di",
    (np.dtype(np.float64), np.dtype(np.int64)): "dl",
    (np.dtype(np.complex128), np.dtype(np.int32)): "zi",
    (np.dtype(np.complex128), np.dtype(np.int64)): "zl",
}


def find_permutation(arr1: np.ndarray, arr2: np.ndarray,
                     max_val: int | None = None) -> np.ndarray:
    """Permutation ``p`` with ``arr1[p] == arr2`` for (N, 2) index arrays.

    Provided for reference-API parity (Sparse.py:46-85); nothing in the
    port needs a stored transpose permutation.  Unlike the reference's
    ``is2[is2[is2]]`` trick (valid only for sorted-unique patterns), this
    inverts the argsort explicitly, so it is correct for any
    duplicate-free pair of patterns.
    """
    arr1 = np.asarray(arr1)
    arr2 = np.asarray(arr2)
    if arr1.shape != arr2.shape or arr1.ndim != 2 or arr1.shape[1] != 2:
        raise ValueError("expected two (N, 2) integer arrays of equal shape")
    if max_val is None:
        max_val = int(max(arr1.max(initial=0), arr2.max(initial=0))) + 1
    u1 = arr1[:, 0].astype(np.int64) + arr1[:, 1].astype(np.int64) * max_val
    u2 = arr2[:, 0].astype(np.int64) + arr2[:, 1].astype(np.int64) * max_val
    is1 = np.argsort(u1)
    is2 = np.argsort(u2)
    inv2 = np.empty_like(is2)
    inv2[is2] = np.arange(is2.size)
    return is1[inv2].astype(arr1.dtype)


class SymbolicPattern:
    """Static sparsity pattern of a square matrix — the 'symbolic' half of
    the reference's symbolic/numeric split (InnerState.add_mat performs the
    UMFPACK symbolic factorization once per pattern, InnerState.h:120-162).

    Holds the canonical entry order as int32 numpy arrays and the size;
    hashable through a lazily computed content digest.  The K3 plans of
    the pattern and of its transpose are built on first use on a device
    and kept here (``plans``)."""

    __slots__ = ("n", "_rows", "_cols", "_hash", "_plans")

    def __init__(self, n: int, rows, cols):
        self.n = int(n)
        self._rows = np.ascontiguousarray(rows, dtype=np.int32)
        self._cols = np.ascontiguousarray(cols, dtype=np.int32)
        self._rows.setflags(write=False)
        self._cols.setflags(write=False)
        self._hash = None
        self._plans = {}

    @property
    def nnz(self) -> int:
        return int(self._rows.size)

    def rows_array(self) -> np.ndarray:
        return self._rows

    def cols_array(self) -> np.ndarray:
        return self._cols

    def plans(self, device):
        """(plan, transposed plan) of the pattern on ``device``: the CSR
        copies and tile plans of A and of A^T (the swapped pattern), both
        reading the data in the canonical order."""
        device = torch.device(device)
        if device not in self._plans:
            r = torch.as_tensor(self._rows.astype(np.int64), device=device)
            c = torch.as_tensor(self._cols.astype(np.int64), device=device)
            self._plans[device] = (build_csr(r, c, self.n),
                                   build_csr(c, r, self.n))
        return self._plans[device]

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(
                (self.n, self._rows.tobytes(), self._cols.tobytes()))
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, SymbolicPattern) and self.n == other.n
                and np.array_equal(self._rows, other._rows)
                and np.array_equal(self._cols, other._cols))

    def __repr__(self):
        return f"SymbolicPattern(n={self.n}, nnz={self.nnz})"


def create_symbolic(N: int, indices: np.ndarray,
                    mat_dtype=np.float64) -> tuple[tuple, SymbolicPattern]:
    """Canonicalize a COO pattern: returns ``((row, col), pattern)``.

    Matches the reference contract (Sparse.py:92-116): the returned
    ``(row, col)`` is the CSC entry order (sorted by column, then row) with
    duplicates merged, and ``data`` arrays passed to :func:`matvec` /
    :func:`spsolve` must live in that order (duplicate source entries
    summed by the caller, e.g. via ``np.add.at`` over the inverse map).
    """
    indices = np.asarray(indices)
    if indices.ndim != 2 or indices.shape[1] != 2:
        raise ValueError("indices must be (nnz, 2) [row, col] pairs")
    fam = (np.dtype(mat_dtype), indices.dtype)
    if fam not in FAMILIES and np.dtype(mat_dtype) not in (
            np.dtype(np.float32), np.dtype(np.complex64)):
        raise TypeError(
            f"unsupported dtype family {fam}; expected one of "
            f"{list(FAMILIES)} or the 32-bit twins")
    r = indices[:, 0].astype(np.int64)
    c = indices[:, 1].astype(np.int64)
    if r.size and (r.min() < 0 or r.max() >= N or c.min() < 0 or c.max() >= N):
        raise ValueError("indices out of range for an NxN matrix")
    key = c * N + r                       # CSC order: by column, then row
    uniq = np.unique(key)
    rows = (uniq % N).astype(np.int32)
    cols = (uniq // N).astype(np.int32)
    pat = SymbolicPattern(int(N), rows, cols)
    return (rows, cols), pat


def _plans(pattern: SymbolicPattern, device, indices):
    """The (plan, transposed plan) pair: the pattern's own, or for an
    ``indices`` override (rows, cols) two plans built for this call."""
    if indices is None:
        return pattern.plans(device)
    r, c = (torch.as_tensor(i, device=device).long() for i in indices)
    return build_csr(r, c, pattern.n), build_csr(c, r, pattern.n)


def _common(data, vec):
    """``data`` and ``vec`` as tensors of their promoted dtype, on the
    data's device (the JAX package's ``promote_types``)."""
    data = torch.as_tensor(data)
    vec = torch.as_tensor(vec, device=data.device)
    dt = torch.promote_types(data.dtype, vec.dtype)
    return data.to(dt), vec.to(dt)


def _product(data, vec, csr, csr_t):
    """A vec on the plan ``csr`` (``csr_t``: its transpose's, for the
    derivative in vec): real data is one K3 product, complex data its (re,
    im) stack on the (re, im) lanes of vec, still one launch."""
    if not data.is_complex():
        return csr_apply(data[None], vec, csr, None, csr_t)[0]
    y = csr_apply(torch.stack([data.real, data.imag]),
                  torch.stack([vec.real, vec.imag]), csr, None, csr_t)
    return torch.complex(y[0, 0] - y[1, 1], y[0, 1] + y[1, 0])


def matvec(pattern: SymbolicPattern, data, vec, transpose: bool = False,
           indices=None):
    """``A @ vec`` (or ``A.T @ vec``) over the static pattern: ``data``
    (nnz,) in the canonical order, ``vec`` (..., n); f64 / f32 or complex
    (promoted together).  One K3 launch on the pattern's plan, or on the
    transposed pattern's for ``transpose``; differentiable in ``data`` and
    ``vec`` (the cotangent of ``data`` the pattern-restricted outer product
    ``ct[row] * vec[col]``, the reference's transpose rule,
    Sparse.py:168-176; that of ``vec`` one K3 product on the other plan);
    batch with leading dims of ``vec`` or ``torch.func.vmap``.

    ``indices``: optional ``(rows, cols)`` overriding the pattern's host
    arrays (its plans are then built for this call).
    """
    data, vec = _common(data, vec)
    csr, csr_t = _plans(pattern, data.device, indices)
    if transpose:
        csr, csr_t = csr_t, csr
    return _product(data, vec, csr, csr_t)


class _Solve:
    """One side of a solve: the pattern's plans, its entries' (row,
    column) as the solve sees them (swapped for the transpose), and the
    refinement rounds."""

    def __init__(self, n, csr, csr_t, refine_steps):
        self.n, self.csr, self.csr_t = n, csr, csr_t
        self.refine_steps = refine_steps

    def transposed(self):
        return _Solve(self.n, self.csr_t, self.csr, self.refine_steps)


def _exact_product(data, X, csr):
    """A X for the lanes X (m, n), every row sum exact before one rounding
    (``mixed._dd_spmv``: exact products, Rump's extraction, one K3 pass);
    complex data as its (re, im) stack on the (re, im) lanes, each of the
    four real products so rounded once."""
    from .mixed import _dd_spmv

    n = csr.n
    if not data.is_complex():
        return _dd_spmv(data[None], X, csr.rows, csr.cols, n, csr)[0]
    m = X.shape[0]
    out = _dd_spmv(torch.stack([data.real, data.imag]),
                   torch.cat([X.real, X.imag]), csr.rows, csr.cols, n, csr)
    return torch.complex(out[0, :m] - out[1, m:], out[0, m:] + out[1, :m])


def _solve_once(data, b, sv: _Solve):
    """x = A^-1 b for one matrix (data (nnz,)) and b (..., n): a dense LU
    in the data's dtype, then each right-hand side solved on its own (a
    multi-column solve rounds otherwise, so a batch would change a
    column's bits), then the refinement rounds: the residual b - A x from
    K3's exact product (rounded once, so its error is eps |b| however
    much the row's terms cancel), solved again on the same LU."""
    n = sv.n
    A = to_dense(data, sv.csr.rows, sv.csr.cols, n)
    lu, piv = torch.linalg.lu_factor(A)
    B = b.reshape(-1, n).T

    def solve(rhs):
        return torch.cat([torch.linalg.lu_solve(lu, piv, rhs[:, j:j + 1])
                          for j in range(rhs.shape[1])], dim=1)

    X = solve(B)
    for _ in range(sv.refine_steps):
        R = B - _exact_product(data, X.T.contiguous(), sv.csr).T
        X = X + solve(R)
    return X.T.reshape(b.shape)


class _SpSolve(torch.autograd.Function):
    """x = A^-1 b on a pattern, differentiable in ``data`` and ``b`` by
    reverse and forward mode, under ``torch.func`` transforms too."""

    @staticmethod
    def forward(data, b, sv):
        return _solve_once(data, b, sv)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, b, sv = inputs
        ctx.sv = sv
        ctx.save_for_backward(data, output)
        ctx.save_for_forward(data, output)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gx):
        data, x = ctx.saved_tensors
        if gx is None:
            return None, None, None
        sv = ctx.sv
        # one transposed solve: gb = A^-H gx (conj is a no-op on real data)
        dh = data.conj_physical() if data.is_complex() else data
        gb = _SpSolve.apply(dh, gx, sv.transposed())
        gd = None
        if ctx.needs_input_grad[0]:
            # the pattern-restricted outer product -gb x^H, summed over the
            # right-hand sides
            n = sv.n
            gd = -(gb.reshape(-1, n)[:, sv.csr.rows]
                   * x.reshape(-1, n)[:, sv.csr.cols].conj()).sum(0)
        return gd, (gb if ctx.needs_input_grad[1] else None), None

    @staticmethod
    def jvp(ctx, d_data, d_b, _sv):
        data, x = ctx.saved_tensors
        sv = ctx.sv
        rhs = d_b
        if d_data is not None:
            dAx = _product(d_data, x, sv.csr, sv.csr_t)
            rhs = -dAx if rhs is None else rhs - dAx
        if rhs is None:
            return None
        return _SpSolve.apply(data, rhs, sv)

    @staticmethod
    def vmap(info, in_dims, data, b, sv):
        if in_dims[1] is not None:
            b = b.movedim(in_dims[1], 0)
        if in_dims[0] is None:
            # a batch of right-hand sides: one factorization for all
            return _SpSolve.apply(data, b, sv), 0
        # a batch of matrices: one factorization each, as one call would
        data = data.movedim(in_dims[0], 0)
        bs = b if in_dims[1] is not None else [b] * data.shape[0]
        return torch.stack([_SpSolve.apply(d, bb, sv)
                            for d, bb in zip(data, bs)]), 0


def spsolve(pattern: SymbolicPattern, data, b, transpose: bool = False,
            refine_steps: int | None = None, indices=None):
    """Solve ``A x = b`` (or ``A^T x = b``) on the static pattern, with AD.

    ``data`` (nnz,) in the canonical order, ``b`` (n,) or (..., n) (each
    leading index a right-hand side of the same matrix), promoted to one
    dtype (f64 or complex128; f32 / complex64 factor in their own).  Numeric
    recipe per call: densify onto (n, n), one LU factorization of the
    matrix in that dtype, one triangular solve pair per right-hand side
    (so a column's bits do not depend on its batch), then
    ``refine_steps`` rounds of iterative refinement against K3's exact
    product (every row sum of A x exact before one rounding, so a round
    takes the solution's error from the LU's kappa * eps towards eps;
    None: 0 — the JAX package's default where its LU is 64-bit; each
    round costs one exact product and one solve).

    AD: reverse mode performs one transposed solve (same recipe) and the
    pattern-restricted outer product for ``data``; forward mode one solve
    of the tangent system.  Composes with ``torch.func.vmap`` (batched
    right-hand sides share one factorization, batched matrices are
    factored one at a time), ``jacrev`` / ``jacfwd`` and Hessians.

    ``indices``: optional ``(rows, cols)`` overriding the pattern's host
    arrays (its plans are then built for this call).
    """
    data, b = _common(data, b)
    csr, csr_t = _plans(pattern, data.device, indices)
    sv = _Solve(pattern.n, csr, csr_t,
                0 if refine_steps is None else int(refine_steps))
    if transpose:
        sv = sv.transposed()
    return _SpSolve.apply(data, b, sv)
