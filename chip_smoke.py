#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path once at a real size — the 21k-DOF band tier
(``sh_i`` strip, refine = 4, isotropic steel, AP1030, 512 frequencies over
40-600 Hz) through ``Problem(...).solveForward`` on ``cuda`` — and checks it:

1. a CUDA device is present; print the card's name and power limit;
2. build the hand-written band kernel (``csrc/band_mv.cu``) with nvcc;
3. hold the kernel, which reads the band's nonzero tiles packed once in
   ``getFRCore`` (``[pack]``), against its plain torch version on the same
   pack, at the slice's own shape (B = 128, 16 and 2) and at a synthetic
   b = 64 block size, to 1e-5 of max |y| (the f32 sums of a row run in
   another order); time both, the library call of the same product (one
   ``torch.matmul`` on the dense band, ``library_ms``) and the kernel with
   the L2 flushed, in turns, and state the kernel's bound (``[bound]``);
4. run the 512-point sweep, count the kernel's launches (must be > 0) and
   check that the FRF is finite;
5. hold the FRF against a host f64 sparse-LU oracle at 4 points including
   the |FRF| peak, to 1e-6 relative.

Any failed phase raises and the script exits non-zero.  The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
(``--ab SOURCE``, repeatable, also builds another version of K1, with the
earlier dense-band or the packed C interface, and times it beside the
kernel in the tree, in turns.)
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

N_FREQ = 512
KERNEL_TOL = 1e-5
SLEEP_CYCLES = 20_000_000   # ~10 ms of device sleep ahead of a timed run
ORACLE_TOL = 1e-6


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its template
    arguments, registers, shared memory and spills."""
    out, name, spill = [], "kernel", ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"ILi(\d+)ELb(\d)E", line)
            name = f"<S={m[1]}, vec={m[2]}>" if m else "kernel"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split('info    :')[-1].strip()}; "
                       f"{spill}")
    return out


def time_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(device ms, host ms) per call, after a warm-up.  A device-side sleep
    queued first lets the host enqueue every call before the first one
    runs, so the CUDA events around them time the device alone and the host
    clock times the enqueue alone."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def time_flushed_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call with the 50 MB L2 flushed before each
    call by writing a 64 MiB buffer (CUDA events around the call alone)."""
    import torch

    flush = torch.empty(16 * 2**20, device="cuda")
    for _ in range(3):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def library_mv(band, layout):
    """The yardstick (``library_ms``; the port never calls it): one
    ``torch.matmul`` of an ``as_strided`` window view of the zero-padded x
    against band^T, (nb, B, 3b) @ (nb, 3b, b) -> (nb, B, b).  Returns
    (pad, run): ``pad`` makes the padded x and is not timed."""
    import torch

    nb, b, n = layout.nb, layout.b, layout.n
    band_t = band.transpose(-1, -2)

    def pad(x):
        xp = torch.zeros(x.shape[0], (nb + 2) * b, device=x.device)
        xp[:, b:b + n] = x
        return xp

    def run(xp):
        win = xp.as_strided((nb, xp.shape[0], 3 * b), (b, (nb + 2) * b, 1))
        return torch.matmul(win, band_t)

    return pad, run


def load_ab_kernel(source: str):
    """Build another version of K1 from ``source``, for an A/B beside the
    kernel in the tree (it is not part of the port), and return its
    launcher ``run(pack, band, x, layout) -> y``.  The C interface is the
    earlier dense-band ``band_mv_f32_launch(band, x, y, B, n, nb, b,
    stream)`` or, where the library exports ``band_mv_f32_tile``, the
    packed one of ``csrc/band_mv.cu`` (on a pack of the tile shape it was
    built for)."""
    import ctypes
    import os

    import torch
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    name = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(band_kernel.BUILD_DIR, f"libab_{name}.so")
    os.makedirs(band_kernel.BUILD_DIR, exist_ok=True)
    res = subprocess.run([band_kernel._nvcc(), *band_kernel.NVCC_FLAGS,
                          "-o", lib_path, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    for line in ptxas_summary(res.stdout + res.stderr):
        print(f"[build] {name}: {line}", flush=True)
    lib = ctypes.CDLL(lib_path)
    packed = hasattr(lib, "band_mv_f32_tile")
    tile = divmod(lib.band_mv_f32_tile(), 1000) if packed else None
    repacked = {}
    lib.band_mv_f32_launch.argtypes = [ctypes.c_void_p] * (
        5 if packed else 3) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.band_mv_f32_launch.restype = ctypes.c_int

    def run(pack, band, x, layout):
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        if packed and pack.tile != tile:
            if id(band) not in repacked:
                repacked.clear()
                repacked[id(band)] = band_kernel.pack_band_tiles(
                    band, layout, tile)
            pack = repacked[id(band)]
        if packed:
            rc = lib.band_mv_f32_launch(
                pack.vals.data_ptr(), pack.col0.data_ptr(),
                pack.row_ptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                x.shape[0], layout.n, pack.n_row_tiles, pack.list_max,
                stream)
        else:
            rc = lib.band_mv_f32_launch(
                band.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[0],
                layout.n, layout.nb, layout.b, stream)
        if rc != 0:
            raise RuntimeError(f"{source}: cudaError {rc}")
        return y

    return name, run


def compare_kernel(pack, band, x, layout, label: str, ab=()) -> dict:
    """Kernel vs plain version on the same inputs (errors), and the device
    times of the kernel, the plain version, the library call and the A/B
    kernels ``ab`` ((name, run) pairs), in turns; the kernel also with the
    L2 flushed before each launch, and its host enqueue time."""
    import torch
    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        band_mv_f32_cuda, band_mv_f32_reference)

    y_ref = band_mv_f32_reference(pack, x, layout)
    y = band_mv_f32_cuda(pack, x, layout)
    pad, run = library_mv(band, layout)
    xp = pad(x)
    y_lib = run(xp).permute(1, 0, 2).reshape(x.shape[0], -1)[:, :layout.n]
    torch.cuda.synchronize()
    scale = max(float(y_ref.abs().max()), 1e-30)
    max_abs = float((y - y_ref).abs().max())
    rel = max_abs / scale
    errs = {"library": float((y_lib - y_ref).abs().max()) / scale}
    variants = {"ms": lambda: band_mv_f32_cuda(pack, x, layout),
                "plain_ms": lambda: band_mv_f32_reference(pack, x, layout),
                "library_ms": lambda: run(xp)}
    for name, fn in ab:
        errs[name] = float((fn(pack, band, x, layout) - y_ref).abs().max()
                           ) / scale
        variants[f"{name}_ms"] = (lambda fn=fn: fn(pack, band, x, layout))
    # in turns: a b c ..., ... c b a
    order = list(variants) + list(variants)[::-1]
    times = {k: [] for k in variants}
    for k in order:
        times[k].append(time_ms(variants[k]))
    rec = {k: float(np.mean([d for d, _ in v])) for k, v in times.items()}
    rec.update(max_abs_err=max_abs, rel_err=rel, B=x.shape[0],
               host_ms=float(np.mean([h for _, h in times["ms"]])),
               flushed_ms=time_flushed_ms(variants["ms"]),
               **{f"{k}_rel_err": e for k, e in errs.items()})
    others = "  ".join(f"{k[:-3]} {v:.4f} ms (rel {errs[k[:-3]]:.1e})"
                       for k, v in rec.items()
                       if k.endswith("_ms") and k[:-3] in errs)
    print(f"[kernel] {label}: B={x.shape[0]} nb={layout.nb} b={layout.b} "
          f"n={layout.n}  max|dy|={max_abs:.3e} rel={rel:.3e}  kernel "
          f"{rec['ms']:.4f} ms (L2 flushed {rec['flushed_ms']:.4f}; host "
          f"enqueue {rec['host_ms']:.4f})  plain {rec['plain_ms']:.4f} ms  "
          f"{others}", flush=True)
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"band kernel disagrees at {label}: rel {rel:.3e}"
                             f" > {KERNEL_TOL}")
    for k, e in errs.items():
        if not e <= KERNEL_TOL:
            raise AssertionError(f"{k} disagrees at {label}: rel {e:.3e} > "
                                 f"{KERNEL_TOL}")
    return rec


def bound_ms(pack, B: int, n: int) -> tuple[float, str]:
    """Least time of the product on an H100 SXM: the band's nonzeros with a
    4-byte index each, x read once and y written once, at 3.35 TB/s,
    against 2 FLOP per nonzero and lane at 67 TFLOP/s (f32, CUDA cores)."""
    nnz = int((pack.vals != 0).sum())
    t_bytes = (8.0 * nnz + 2 * 4.0 * B * n) / 3.35e12
    t_ops = 2.0 * nnz * B / 67e12
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def synthetic_b64(device):
    """The b = 64 narrow-band pattern of tests/test_band.py:203-213."""
    import torch
    from plate_inverse_problem_tpu_torch.ops.band import (
        build_band_layout, flat_to_band)
    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        pack_band_tiles)

    n, w = 400, 9
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    layout = build_band_layout(rows, cols, n, block_multiple=64, min_block=64)
    rng = np.random.default_rng(7)
    vals = torch.as_tensor(rng.standard_normal(rows.size).astype(np.float32),
                           device=device)
    lin = torch.as_tensor(layout.lin, dtype=torch.int64, device=device)
    band = flat_to_band(vals, layout, lin)
    x = torch.as_tensor(rng.standard_normal((8, n)).astype(np.float32),
                        device=device)
    return pack_band_tiles(band, layout), band, x, layout


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="SOURCE", action="append", default=[],
                    help="also build this version of K1 (the earlier "
                         "dense-band or the packed C interface) and time it "
                         "beside the kernel in the tree, in turns; may be "
                         "repeated")
    args = ap.parse_args()

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); nothing was run.")
    card = card_info()
    print(card, flush=True)   # as nvidia-smi gives it: "<name>, <limit> W"
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smoke(torch.device("cuda"), card, args.ab)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def smoke(dev, card: str, ab_sources=()):
    """Phases 2-5 on ``dev``; prints the kernels' JSON record last.
    ``ab_sources``: other versions of K1 to time beside it (A/B only)."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import band_kernel
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    # ---- 2. build the kernel ---------------------------------------------
    t0 = time.perf_counter()
    report = band_kernel.build()
    print(f"[build] band_mv.cu -> sm_90a in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in ptxas_summary(report):
        print(f"[build] {line}", flush=True)

    # ---- construct the 21k-DOF Problem on the card -------------------------
    t0 = time.perf_counter()
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=4.0)
    p = pt.Problem(geom, mat, acc, device=dev)
    core, od = p.getFRCore()
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    lay = p._band_layout
    print(f"[ctor] n_free={p.n_free} nnz={p.op.pattern.nnz} b={lay.b} "
          f"nb={lay.nb} bandwidth={lay.bandwidth} n_c={p._mg_rl.n_coarse} "
          f"m={od['W64'].shape[1]}  construction {ctor_s:.2f} s (host "
          "assembly, ARPACK basis, coarse splu, transfers)", flush=True)

    pack = p._band_pack
    nnz = int((pack.vals != 0).sum())
    pack_mb = sum(t.numel() * t.element_size()
                  for t in (pack.vals, pack.col0, pack.row_ptr)) / 1e6
    print(f"[pack] tile {pack.tile[0]}x{pack.tile[1]}: {pack.vals.shape[0]} "
          f"tiles of {pack.n_row_tiles} row tiles, {pack_mb:.2f} MB packed, "
          f"{nnz} numeric nonzeros; built once in getFRCore in "
          f"{1e3 * p._pack_build_s:.1f} ms (part of construction)", flush=True)

    # ---- 3. kernel vs plain version on the card ----------------------------
    ab = [load_ab_kernel(src) for src in ab_sources]
    chunk = p._auto_freq_chunk() or N_FREQ
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.standard_normal((chunk, 2, p.n_free)).astype(np.float32),
        device=dev).reshape(2 * chunk, p.n_free)
    recs = {B: compare_kernel(pack, od["mg_band0"], x[:B].contiguous(), lay,
                              "slice (21k K_ref band, f32)", ab)
            for B in (2 * chunk, 16, 2)}
    slice_rec = recs[2 * chunk]
    bound, bound_by = bound_ms(pack, 2 * chunk, p.n_free)
    print(f"[bound] slice B={2 * chunk}: {1e3 * bound:.2f} us ({bound_by}: "
          f"{nnz} nonzeros x 8 B + x + y at 3.35 TB/s, 2 FLOP a nonzero and "
          f"lane at 67 TFLOP/s); kernel at {100 * bound / slice_rec['ms']:.1f}"
          " % of it", flush=True)
    b64 = compare_kernel(*synthetic_b64(dev), "synthetic b=64", ab)

    # ---- 4. the 512-point sweep through the main path ---------------------
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    torch.cuda.reset_peak_memory_stats()
    band_kernel.band_mv_f32_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = p.solveForward(freqs)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = band_kernel.band_mv_f32_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the same sweep again: what every later sweep of a process costs
    t0 = time.perf_counter()
    p.solveForward(freqs)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    fr = fr.cpu().numpy()
    print(f"[sweep] {N_FREQ} points over 40-600 Hz: first {sweep_s:.3f} s "
          f"({N_FREQ / sweep_s:.1f} solves/s), steady {steady_s:.3f} s "
          f"({N_FREQ / steady_s:.1f} solves/s); freq_chunk={chunk}, "
          f"band kernel launches={launches}, peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    if launches <= 0:
        raise AssertionError("the sweep never launched the band kernel")
    if fr.shape != (N_FREQ,) or not np.all(np.isfinite(fr)):
        raise AssertionError(f"bad FRF: shape {fr.shape}, "
                             f"finite={np.all(np.isfinite(fr))}")

    # ---- 5. host f64 splu oracle at 4 points including the peak -----------
    ipk = int(np.argmax(fr))
    idx = [3, ipk, N_FREQ // 2, N_FREQ - 1]
    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    for i, r in zip(idx, rel):
        print(f"[oracle] f={freqs[i]:8.3f} Hz  rel err {r:.3e}"
              f"{'  <-- peak' if i == ipk else ''}", flush=True)
    worst = float(rel.max())
    print(f"[oracle] worst rel err vs f64 splu (4 pts incl. peak): "
          f"{worst:.3e}", flush=True)
    if not worst <= ORACLE_TOL:
        raise AssertionError(f"worst rel err {worst:.3e} > {ORACLE_TOL}")

    summary = {"card": card, "n_free": p.n_free, "ctor_s": ctor_s,
               "pack_build_ms": 1e3 * p._pack_build_s,
               "pack_tiles": pack.vals.shape[0], "pack_mb": pack_mb,
               "sweep_first_s": sweep_s, "sweep_steady_s": steady_s,
               "solves_per_s_steady": N_FREQ / steady_s,
               "peak_mem_gb": peak_gb, "worst_rel_err": worst,
               "f_peak": float(freqs[ipk]), "k1_by_B": recs, "k1_b64": b64}
    print(f"[summary] {json.dumps(summary)}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "band_mv_f32",
        "route": "cuda",
        "source": "plate_inverse_problem_tpu_torch/csrc/band_mv.cu",
        "replaces": "plate_inverse_problem_tpu/ops/pallas_band.py:75",
        "launches": launches,
        "max_abs_err": slice_rec["max_abs_err"],
        "ms": slice_rec["ms"],
        "plain_ms": slice_rec["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": slice_rec["library_ms"],
    }]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
