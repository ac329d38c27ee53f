"""K3: the flat-pattern operator as a hand-written CUDA kernel
(``csrc/csr_mv.cu``), a stacked CSR matvec with no atomics.

Counterpart of the JAX package's ``ops/mixed.py`` ``_fused_mv`` (l.651) and
``ops/scatter.py`` ``spmv_flat`` (l.22), which XLA runs as segmented
scatters (no Pallas kernel).  S operators on one sparsity pattern (K, M
and K_im, or the tangents of their data) applied to L lanes:

    y[s, ..., i] = sum_{k in row i} data[s, k] * x[..., col[k]]

Every output element is summed in one fixed order, so two launches give
the same bits; the ``index_add_`` scatter that ran here before summed with
f64 atomics in no fixed order, and FGMRES carried that last-bit noise up to
its tolerance.  The pieces:

* ``CSRPattern`` / ``build_csr`` — a CSR copy of the flat (rows, cols)
  pattern (rows sorted, a ``rowptr`` added), built once per ``getFRCore``;
* ``scatter_mv`` — the plain torch version: ``index_add_`` over the flat
  COO pattern, used for CPU tensors and as the kernel's reference;
* ``csr_mv_cuda`` — checks its inputs, transposes x to (n, L) so the
  kernel's lane reads coalesce, allocates the output with ``torch.empty``,
  launches the kernel on the current stream (once per group of up to 4
  operators) and raises if a launch fails; ``csr_mv_cuda.launches`` counts
  the kernels launched, as the C launcher reports them;
* ``csr_mv`` — the dispatch: the kernel for a CUDA tensor, the plain
  version for a CPU tensor, nothing else;
* ``CSRMatVec`` / ``csr_apply`` — the same map as a
  ``torch.autograd.Function`` for the residual map of the adjoint Jacobian
  and the loss gradient: ``jvp`` is the map on the tangent data (it is
  linear), ``backward`` for ``data`` is a gather and a sum over the lanes
  (no scatter), ``vmap`` folds batched data into the operator stack; x is
  a constant;
* ``build`` — compiles the source with ``nvcc`` for ``sm_90a`` into
  ``build/kernels/`` at first use, and loads it with ``ctypes``.

Nothing here falls back: a CUDA tensor always goes to the kernel, and a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from .band_kernel import BUILD_DIR, _PKG_DIR, compile_source

SOURCE = os.path.join(_PKG_DIR, "csrc", "csr_mv.cu")
_LIB_PATH = os.path.join(BUILD_DIR, "libcsr_mv.so")

_lib = None


@dataclass(frozen=True)
class CSRPattern:
    """A flat (rows, cols) pattern of n x n operators with its CSR copy.

    ``rows``/``cols`` (nnz,) int64: the flat pattern in the operator data's
    own order (the plain version's); ``rowptr`` (n + 1,) and ``col`` (nnz,)
    int32: the CSR copy, rows ascending, each row's entries by column;
    ``perm`` (nnz,) int64, the flat slot of every CSR slot, or None where
    the flat order is already the CSR order."""
    rows: torch.Tensor
    cols: torch.Tensor
    rowptr: torch.Tensor
    col: torch.Tensor
    perm: torch.Tensor | None
    n: int

    @property
    def nnz(self) -> int:
        return self.col.numel()


def build_csr(rows, cols, n: int) -> CSRPattern:
    """The CSR copy of the flat pattern (rows, cols) (tensors on the
    operator data's device), sorted on the host."""
    dev = rows.device
    r = rows.detach().cpu().numpy().astype(np.int64)
    c = cols.detach().cpu().numpy().astype(np.int64)
    if r.size >= 2**31:
        raise ValueError(f"{r.size} nonzeros exceed the kernel's int32 index.")
    order = np.argsort(r * n + c, kind="stable")
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(r, minlength=n))
    perm = (None if np.array_equal(order, np.arange(r.size))
            else torch.as_tensor(order, device=dev))
    return CSRPattern(
        rows=torch.as_tensor(r, device=dev), cols=torch.as_tensor(c, device=dev),
        rowptr=torch.as_tensor(rowptr, dtype=torch.int32, device=dev),
        col=torch.as_tensor(c[order], dtype=torch.int32, device=dev),
        perm=perm, n=int(n))


def build() -> str:
    """Compile ``csrc/csr_mv.cu`` (``band_kernel.compile_source``) and load
    it.  Returns the compiler's report of the build."""
    global _lib
    report = compile_source(SOURCE, _LIB_PATH)
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        for name in ("csr_mv_f64_launch", "csr_mv_f32_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return report


def scatter_mv(data, x, rows, cols, n: int, seg: int | None = None):
    """Plain torch y = data x: the (S, nnz) operator stack on the flat
    pattern applied to (..., n), output (S, ..., n), by ``index_add`` over
    the rows.  The nnz axis goes in segments of ``seg`` entries (None: one
    pass), each segment's (S, ..., seg) contribution tensor short-lived.
    Out of place, so forward- and reverse-mode AD both run through it."""
    S, nnz = data.shape
    seg = nnz if seg is None else max(1, int(seg))
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
    if data.dim() != 2 or data.shape[1] != csr.nnz or x.shape[-1] != csr.n:
        raise ValueError(f"shape mismatch: data {tuple(data.shape)}, x "
                         f"{tuple(x.shape)}, pattern of {csr.nnz} nonzeros "
                         f"and n={csr.n}.")


def csr_mv_cuda(data, x, csr: CSRPattern):
    """y = data x through the CUDA kernel: data (S, nnz) f64 or f32 in the
    flat order, x (..., n) of the same dtype, both on the pattern's CUDA
    device; output (S, ..., n)."""
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
    L = int(np.prod(lead, dtype=np.int64))
    y = torch.empty((S, L, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:   # nothing to launch
        return y.reshape((S,) + lead + (n,))
    d = (data if csr.perm is None else data[:, csr.perm]).contiguous()
    xt = x.reshape(L, n).t().contiguous()                # (n, L)
    fn = (_lib.csr_mv_f64_launch if x.dtype == torch.float64
          else _lib.csr_mv_f32_launch)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(d.data_ptr(), csr.rowptr.data_ptr(), csr.col.data_ptr(),
                xt.data_ptr(), y.data_ptr(), S, L, n, csr.nnz, stream)
    if rc < 0:
        raise RuntimeError(f"csr_mv kernel launch failed: cudaError {-rc}.")
    csr_mv_cuda.launches += rc
    return y.reshape((S,) + lead + (n,))


csr_mv_cuda.launches = 0


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


_X_CONSTANT = ("csr_apply is differentiable in the operator data only; "
               "x is a constant of the residual map.")


def _data_grad(gy, x, csr: CSRPattern, seg: int | None):
    """d<gy, data x>/d data: sum over the lanes of gy at each entry's row
    times x at its column, (S, nnz), nnz in segments of ``seg`` — a gather
    and a reduction, no scatter."""
    S, n, nnz = gy.shape[0], csr.n, csr.nnz
    seg = nnz if seg is None else max(1, int(seg))
    g2 = gy.reshape(S, -1, n)
    x2 = x.reshape(-1, n).to(gy.dtype)
    return torch.cat([
        torch.einsum("sln,ln->sn", g2[..., csr.rows[lo:lo + seg]],
                     x2[:, csr.cols[lo:lo + seg]])
        for lo in range(0, nnz, seg)], dim=1)


class CSRMatVec(torch.autograd.Function):
    """``csr_mv(data, x, csr, seg)`` differentiable in ``data`` by forward
    and reverse mode, under ``torch.func`` transforms too (``jacfwd`` =
    vmap of jvp).  x is a constant of every path (the residual map's fixed
    U): a derivative in x raises."""

    @staticmethod
    def forward(data, x, csr, seg):
        return csr_mv(data, x, csr, seg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, x, csr, seg = inputs
        ctx.csr, ctx.seg = csr, seg
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        # an input without a tangent gets None, not a tensor of zeros (one
        # K3 product on zeros in every jvp otherwise)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError(_X_CONSTANT)
        gd = (_data_grad(gy, x, ctx.csr, ctx.seg)
              if ctx.needs_input_grad[0] and gy is not None else None)
        return gd, None, None, None

    @staticmethod
    def jvp(ctx, d_data, d_x, _csr, _seg):
        if d_x is not None:
            raise NotImplementedError(_X_CONSTANT)
        if d_data is None:
            return None
        (x,) = ctx.saved_tensors
        return CSRMatVec.apply(d_data, x, ctx.csr, ctx.seg)

    @staticmethod
    def vmap(info, in_dims, data, x, csr, seg):
        if in_dims[1] is not None:
            raise NotImplementedError(_X_CONSTANT)
        # batched data (the tangents of jacfwd): fold the batch into the
        # operator stack, one product for all of them
        data = data.movedim(in_dims[0], 0)
        B, S = data.shape[:2]
        out = CSRMatVec.apply(data.reshape(B * S, -1), x, csr, seg)
        return out.reshape((B, S) + out.shape[1:]), 0


def csr_apply(data, x, csr: CSRPattern, seg: int | None = None):
    """Differentiable ``csr_mv`` (``CSRMatVec``): the residual map's
    operator apply."""
    return CSRMatVec.apply(data, x, csr, seg)
