"""The f32 band matvec as a hand-written CUDA kernel (``csrc/band_mv.cu``)
over a packed list of the band's nonzero tiles.

Counterpart of the JAX package's Pallas kernel ``ops/pallas_band.py``
(``_kernel`` / ``_band_mv_pallas`` / ``band_mv_pallas``).  The band of the
preconditioner never changes during a sweep, so it is packed once per
geometry and every apply reads only the pack.  Five pieces:

* ``pack_band_tiles`` — plain torch on any device: the band's nonzero
  ``TILE`` = 16 x 8 tiles (``BandTiles``), built once per ``Problem``;
* ``band_mv_f32`` — what the preconditioner calls: the kernel for a CUDA
  tensor, the plain version for a CPU tensor;
* ``band_mv_f32_reference`` — the plain torch version on the same pack
  (gather each tile's x slice, one batched ``einsum`` over the tiles,
  ``index_add_`` into the rows), used for CPU tensors and as the kernel's
  reference on the card;
* ``band_mv_f32_cuda`` — checks the pack and x, allocates the output with
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
from dataclasses import dataclass

import torch

from .band import BandLayout

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "band_mv.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_LIB_PATH = os.path.join(BUILD_DIR, "libband_mv.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# rows x columns of a packed tile: the kernel is compiled for this shape
# (the count behind the choice is in csrc/band_mv.cu)
TILE = (16, 8)

_lib = None


@dataclass(frozen=True)
class BandTiles:
    """The nonzero tiles of a band (nb, b, 3b), packed for the kernel.

    ``vals`` (n_tiles, TM, TK) f32: the values of every tile holding a
    nonzero; ``col0`` (n_tiles,) int32: the global first column
    (q - 1) * b + c0 of each tile; ``row_ptr`` (n_row_tiles + 1,) int32: the
    tiles of row tile R are ``row_ptr[R]:row_ptr[R + 1]``, in column order;
    ``list_max``: the most tiles a row tile holds.
    """
    vals: torch.Tensor
    col0: torch.Tensor
    row_ptr: torch.Tensor
    n: int
    list_max: int

    @property
    def tile(self) -> tuple[int, int]:
        return tuple(self.vals.shape[1:])

    @property
    def n_row_tiles(self) -> int:
        return self.row_ptr.numel() - 1


def pack_band_tiles(band, layout: BandLayout, tile=TILE) -> BandTiles:
    """Pack the ``tile`` = (TM, TK) tiles of ``band`` (nb, b, 3b) that hold
    a nonzero, on the band's device.  Window slots outside [0, n) and rows
    >= n are dropped first, so the pack does not depend on what the band
    stores there."""
    nb, b, n = layout.nb, layout.b, layout.n
    tm, tk = tile
    if tuple(band.shape) != (nb, b, 3 * b):
        raise ValueError(f"band {tuple(band.shape)} is not (nb, b, 3b) = "
                         f"{(nb, b, 3 * b)}.")
    if b % tm or b % tk:
        raise ValueError(f"tile {tile} does not divide the block size {b}.")
    dev = band.device
    q = torch.arange(nb, device=dev)[:, None]
    row = q * b + torch.arange(b, device=dev)
    col = (q - 1) * b + torch.arange(3 * b, device=dev)
    keep = (row < n)[:, :, None] & ((col >= 0) & (col < n))[:, None, :]
    tiles = torch.where(keep, band, 0.0).reshape(
        nb, b // tm, tm, 3 * b // tk, tk).transpose(2, 3)
    nonzero = (tiles != 0).any(-1).any(-1)           # (nb, b/tm, 3b/tk)
    qi, ri, ci = torch.nonzero(nonzero, as_tuple=True)
    counts = nonzero.sum(-1).reshape(-1)
    row_ptr = torch.zeros(counts.numel() + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = counts.cumsum(0)
    return BandTiles(vals=tiles[qi, ri, ci].contiguous(),
                     col0=((qi - 1) * b + ci * tk).to(torch.int32),
                     row_ptr=row_ptr, n=n, list_max=int(counts.max()))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA band kernel cannot be "
                           "built (needs the CUDA toolkit).")
    return path


def compile_source(source: str, lib_path: str) -> str:
    """Compile ``source`` with nvcc into the shared library ``lib_path`` if
    the library is missing or older than the source; returns the
    compiler's report (registers, shared memory, spills), kept beside the
    library."""
    log = lib_path + ".log"
    if (not os.path.exists(lib_path) or not os.path.exists(log)
            or os.path.getmtime(lib_path) < os.path.getmtime(source)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
        with open(log, "w") as fh:
            fh.write(res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    with open(log) as fh:
        return fh.read()


def build() -> str:
    """Compile ``csrc/band_mv.cu`` (``compile_source``) and load it.
    Returns the compiler's report of the build."""
    global _lib
    report = compile_source(SOURCE, _LIB_PATH)
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.band_mv_f32_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.band_mv_f32_launch.restype = ctypes.c_int
        lib.band_mv_f32_tile.restype = ctypes.c_int
        built = divmod(lib.band_mv_f32_tile(), 1000)
        if built != TILE:
            raise RuntimeError(f"{_LIB_PATH} was built for {built} tiles, "
                               f"not {TILE}.")
        _lib = lib
    return report


def _check_pack(pack, x, layout: BandLayout) -> None:
    if not isinstance(pack, BandTiles):
        raise TypeError("band_mv_f32 takes the packed band "
                        "(pack_band_tiles), not a dense band.")
    if pack.vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("band_mv_f32 takes an f32 pack and f32 x.")
    if pack.n != layout.n or x.shape[-1] != layout.n:
        raise ValueError(f"shape mismatch: pack for n={pack.n}, x "
                         f"{tuple(x.shape)}, layout n={layout.n}.")


def band_mv_f32_reference(pack: BandTiles, x, layout: BandLayout):
    """Plain torch y = A x in f32 from the pack: each tile's x slice
    gathered, one batched einsum over the tiles, ``index_add_`` into the
    rows."""
    _check_pack(pack, x, layout)
    n = layout.n
    tm, tk = pack.tile
    lead = x.shape[:-1]
    xf = torch.nn.functional.pad(x.reshape(-1, n), (0, tk))  # cols >= n: 0
    cols = pack.col0.long()[:, None] + torch.arange(tk, device=x.device)
    yt = torch.einsum("tik,Btk->Bti", pack.vals, xf[:, cols])
    rt = torch.repeat_interleave(
        torch.arange(pack.n_row_tiles, device=x.device),
        pack.row_ptr.diff().long(), output_size=pack.vals.shape[0])
    rows = (rt[:, None] * tm + torch.arange(tm, device=x.device)).reshape(-1)
    y = torch.zeros(xf.shape[0], pack.n_row_tiles * tm, dtype=x.dtype,
                    device=x.device)
    y.index_add_(1, rows, yt.reshape(xf.shape[0], -1))
    return y[:, :n].reshape(lead + (n,))


def band_mv_f32_cuda(pack: BandTiles, x, layout: BandLayout):
    """y = A x through the CUDA kernel; ``pack`` from ``pack_band_tiles``
    and x (..., n) f32, contiguous and on one CUDA device."""
    _check_pack(pack, x, layout)
    vals, col0, row_ptr = pack.vals, pack.col0, pack.row_ptr
    if not (x.is_cuda and all(t.device == x.device
                              for t in (vals, col0, row_ptr))):
        raise ValueError("band_mv_f32_cuda needs the pack and x on one CUDA "
                         "device.")
    if col0.dtype != torch.int32 or row_ptr.dtype != torch.int32:
        raise TypeError("band_mv_f32_cuda needs int32 tile indices.")
    if (pack.tile != TILE or col0.shape != vals.shape[:1]
            or pack.n_row_tiles * TILE[0] < layout.n):
        raise ValueError(f"pack of {vals.shape[0]} {pack.tile} tiles, "
                         f"{col0.numel()} columns, {pack.n_row_tiles} row "
                         f"tiles does not fit the kernel's {TILE} tiles and "
                         f"n={layout.n}.")
    if not all(t.is_contiguous() for t in (vals, col0, row_ptr, x)):
        raise ValueError("band_mv_f32_cuda needs contiguous tensors.")
    if vals.data_ptr() % 16:
        raise ValueError("band_mv_f32_cuda needs 16-byte aligned tiles.")
    if _lib is None:
        build()
    n = layout.n
    lead = x.shape[:-1]
    xf = x.reshape(-1, n)
    y = torch.empty_like(xf)
    if y.numel() == 0:   # nothing to launch
        return y.reshape(lead + (n,))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib.band_mv_f32_launch(vals.data_ptr(), col0.data_ptr(),
                                     row_ptr.data_ptr(), xf.data_ptr(),
                                     y.data_ptr(), xf.shape[0], n,
                                     pack.n_row_tiles, pack.list_max, stream)
    if rc != 0:
        raise RuntimeError(f"band_mv_f32 kernel launch failed: cudaError {rc}.")
    band_mv_f32_cuda.launches += 1
    return y.reshape(lead + (n,))


band_mv_f32_cuda.launches = 0


def band_mv_f32(pack: BandTiles, x, layout: BandLayout):
    """f32 band matvec of the preconditioner: the CUDA kernel for a CUDA
    tensor, its plain torch version for a CPU tensor."""
    if x.is_cuda:
        return band_mv_f32_cuda(pack, x, layout)
    return band_mv_f32_reference(pack, x, layout)
