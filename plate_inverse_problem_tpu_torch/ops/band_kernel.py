"""The f32 band matvec as a hand-written CUDA kernel (``csrc/band_mv.cu``).

Counterpart of the JAX package's Pallas kernel ``ops/pallas_band.py``
(``_kernel`` / ``_band_mv_pallas`` / ``band_mv_pallas``).  Four pieces:

* ``band_mv_f32`` — what the preconditioner calls: the kernel for a CUDA
  tensor, the plain version for a CPU tensor;
* ``band_mv_f32_reference`` — the plain torch version (the window stack and
  batched ``einsum`` of ``ops/band.band_mv``), used for CPU tensors and as
  the kernel's reference on the card;
* ``band_mv_f32_cuda`` — checks its inputs, allocates the output with
  ``torch.empty``, launches the kernel on the current stream and raises if
  the launch fails.  ``band_mv_f32_cuda.launches`` counts its launches;
* ``build`` — compiles the source with ``nvcc`` for ``sm_90a`` into
  ``build/kernels/`` beside the package at first use, and loads it with
  ``ctypes``.

Nothing here falls back: a CUDA tensor always goes to the kernel, and a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

from .band import BandLayout, band_mv

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "band_mv.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_LIB_PATH = os.path.join(BUILD_DIR, "libband_mv.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA band kernel cannot be "
                           "built (needs the CUDA toolkit).")
    return path


def build() -> str:
    """Compile ``csrc/band_mv.cu`` (if the library is missing or older than
    the source) and load it.  Returns the compiler's report (empty when the
    library was already built)."""
    global _lib
    report = ""
    if (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(SOURCE)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stderr}")
        os.replace(tmp, _LIB_PATH)
        report = res.stdout + res.stderr
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.band_mv_f32_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.band_mv_f32_launch.restype = ctypes.c_int
        _lib = lib
    return report


def band_mv_f32_reference(band, x, layout: BandLayout):
    """Plain torch y = A x in f32: window stack + batched einsum."""
    if band.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("band_mv_f32 takes f32 band and x.")
    return band_mv(band, x, layout)


def band_mv_f32_cuda(band, x, layout: BandLayout):
    """y = A x through the CUDA kernel; band (nb, b, 3b), x (..., n), both
    f32, contiguous and on one CUDA device.

    The kernel skips every 32 x 16 band tile that holds only zeros, so an
    inf or NaN of x reaches only the outputs whose band tiles against it
    hold a nonzero, where the plain version spreads it (0 * NaN = NaN) over
    every row whose window holds it.  A lane with a non-finite x stays
    non-finite all the same wherever the diagonal A[j, j] is nonzero, as it
    is on the plate operators: x[j] always meets it, so y[j] of that lane
    is not finite."""
    n, b, nb = layout.n, layout.b, layout.nb
    if not (band.is_cuda and x.is_cuda and band.device == x.device):
        raise ValueError("band_mv_f32_cuda needs band and x on one CUDA "
                         "device.")
    if band.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("band_mv_f32_cuda takes f32 band and x.")
    if tuple(band.shape) != (nb, b, 3 * b) or x.shape[-1] != n:
        raise ValueError(f"shape mismatch: band {tuple(band.shape)}, x "
                         f"{tuple(x.shape)} for layout nb={nb}, b={b}, n={n}.")
    if not (band.is_contiguous() and x.is_contiguous()):
        raise ValueError("band_mv_f32_cuda needs contiguous tensors.")
    if _lib is None:
        build()
    lead = x.shape[:-1]
    xf = x.reshape(-1, n)
    y = torch.empty_like(xf)
    if y.numel() == 0:   # nothing to launch
        return y.reshape(lead + (n,))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib.band_mv_f32_launch(band.data_ptr(), xf.data_ptr(),
                                     y.data_ptr(), xf.shape[0], n, nb, b,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"band_mv_f32 kernel launch failed: cudaError {rc}.")
    band_mv_f32_cuda.launches += 1
    return y.reshape(lead + (n,))


band_mv_f32_cuda.launches = 0


def band_mv_f32(band, x, layout: BandLayout):
    """f32 band matvec of the preconditioner: the CUDA kernel for a CUDA
    tensor, its plain torch version for a CPU tensor."""
    if x.is_cuda:
        return band_mv_f32_cuda(band, x, layout)
    return band_mv_f32_reference(band, x, layout)
