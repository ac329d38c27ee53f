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
   the |FRF| peak, to 1e-6 relative;
6. the inverse half on the same Problem, from theta_0 = truth x (1.05,
   1.02, 1.2) against the phase-4 FRF at the truth (``[adjoint]``,
   ``[jac]``, ``[gn]``): time ``ResidualFunction("log_afc").value_and_jac``
   (first and steady call) and count K1's launches in its primal and its
   adjoint sweep (both must be > 0); hold 2 J^T r / m against the
   MSE_LOG_AFC loss gradient (GRAD_TOL) and every column of J against a
   central difference of r (FD_STEPS, to FD_TOL of the column's max); run
   ``solveInverse(theta_0, "MSE_LOG_AFC", "gn", use_scaling=True,
   N_steps=GN_STEPS)``, print every iterate's loss and seconds, and
   require the loss to fall at every step and the result to reach the
   truth to 1e-4 relative (|beta|: the FRF magnitude is even in the loss
   factor, so -beta is an exact minimum too);
7. the dense-preconditioner tier (``[dense]``), where K1 must not run:
   (a) the bench configuration as ``bench.py`` builds it (``sh_i`` refine =
   1, n = 1466, ``precond`` and ``operator_layout`` left at "auto", which
   must resolve to the flat layout, the dense preconditioner and an f32
   Krylov basis): a first and a steady 512-point sweep with peak memory,
   the FRF checksum sum |FRF| within 1e-6 of the JAX CPU run's
   (``BENCH_r05.json``) and the worst relative error against the host f64
   splu at bench.py's four points within 1e-6; one steady sweep with
   ``basis_f32=False`` held to the same 1e-6; (b) phase 6's inverse half
   on that Problem; (c) the largest dense-tier plate (refine = 3, n =
   11910, "auto": the band layout with the dense preconditioner): its
   construction with the dense f64 inverse, a first and a steady sweep
   with peak memory, and the splu check at 4 points including the peak.
   K1's launch counter reads 0 over each of them.

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
START = (1.05, 1.02, 1.2)     # theta_0 / truth of phase 6
# 2 J^T r / m vs the loss gradient, relative to its max component.  The two
# come from independent primal and adjoint sweeps, which on the card agree
# only to the sweeps' accuracy (the f64 atomics of the scatters change each
# sweep's last bits and FGMRES carries that to its tolerance): 7.7e-8 to
# 2.4e-7 on an H100 at 700 W, where two calls of the gradient itself differ
# by 6.0e-8 to 2.7e-7.  The FRF gate, 1e-6, bounds it; on the CPU at n = 1466, where
# the sweeps are deterministic, tests/test_torch_inverse.py holds it to
# 1e-8.
GRAD_TOL = 1e-6
# J column vs its central difference, of the column's max.  E and G at a
# relative step of 1e-4, where truncation sets the deviation (CPU, n = 1466,
# E column: 2.2e-5 at 1e-4, 2.2e-3 at 1e-3); beta at 1e-2, because its
# column is bound by the f64 noise of r over 2 h (CPU, 64 points: 1.4e-3 at
# 1e-5, 6.5e-5 at 1e-4, 5.7e-6 at 1e-3, 1.0e-5 at 1e-2; the 21k sweep on
# the card is noisier: 7.6e-4-1.9e-3 at 1e-4).  CPU numbers from
# .probes/torch_sweep_profile.py --fd-cpu.  The tolerance is the bound of
# 1e-3: the worst CPU deviation at these steps is 2.2e-5, the card's E and
# G columns at 1e-4 were 1.4e-4-1.5e-4 and 4.7e-5-7.5e-5 (an H100 at
# 700 W).
FD_STEPS = (1e-4, 1e-4, 1e-2)
FD_TOL = 1e-3
# Gauss-Newton steps: from theta_0 the iterates reach 1.7e-4 / 8.4e-4 (E, G)
# after 8 steps (iterate 8) and 1.0e-6 / 5.2e-6 after 10 on an H100 at
# 700 W; beta ends at -beta, its mirror image
GN_STEPS = 10
GN_TOL = 1e-4                 # relative distance of the GN result to truth
# sum |FRF| of the bench sweep (sh_i refine = 1, 512 points over 40-600 Hz)
# from the JAX package on the CPU (BENCH_r05.json), and its tolerance
BENCH_CHECKSUM = 1584.7714001606384
CHECKSUM_TOL = 1e-6


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
    """Phases 2-7 on ``dev``; prints the kernels' JSON record last.
    ``ab_sources``: other versions of K1 to time beside it (A/B only)."""
    import torch

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
    p = sh_i_problem(dev, 4.0)
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

    inv = inverse_half(p, freqs, fr)
    dense = dense_tier(dev)

    summary = {"card": card, "n_free": p.n_free, "ctor_s": ctor_s,
               "pack_build_ms": 1e3 * p._pack_build_s,
               "pack_tiles": pack.vals.shape[0], "pack_mb": pack_mb,
               "sweep_first_s": sweep_s, "sweep_steady_s": steady_s,
               "solves_per_s_steady": N_FREQ / steady_s,
               "peak_mem_gb": peak_gb, "worst_rel_err": worst,
               "f_peak": float(freqs[ipk]), "k1_by_B": recs, "k1_b64": b64,
               **inv, "dense": dense}
    print(f"[summary] {json.dumps(summary)}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "band_mv_f32",
        "route": "cuda",
        "source": "plate_inverse_problem_tpu_torch/csrc/band_mv.cu",
        "replaces": "plate_inverse_problem_tpu/ops/pallas_band.py:75",
        "launches": launches,
        "launches_by_path": {"sweep": launches,
                             "rj_primal": inv["k1_rj_primal"],
                             "rj_adjoint": inv["k1_rj_adjoint"],
                             "gn": inv["k1_gn"],
                             **dense["k1"]},
        "max_abs_err": slice_rec["max_abs_err"],
        "ms": slice_rec["ms"],
        "plain_ms": slice_rec["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": slice_rec["library_ms"],
    }]}), flush=True)


def sh_i_problem(dev, refine: float, **kw):
    """``sh_i`` strip 100 x 20 x 2 mm, isotropic steel, AP1030 (bench.py's
    plate at refine = 1), on ``dev``."""
    import plate_inverse_problem_tpu_torch as pt

    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=refine)
    return pt.Problem(geom, mat, acc, device=dev, **kw)


def timed_sweeps(p, freqs, label: str) -> dict:
    """A first and a steady sweep, synchronised, with the peak device memory
    of the first and K1's launches over both; prints one [dense] line."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel

    band_kernel.band_mv_f32_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = p.solveForward(freqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fr = fr.cpu().numpy()
    rec = {"sweep_first_s": times[0], "sweep_steady_s": times[1],
           "solves_per_s_steady": freqs.size / times[1],
           "peak_mem_gb": peak_gb,
           "k1": band_kernel.band_mv_f32_cuda.launches}
    print(f"[dense] {label}: {freqs.size} points over 40-600 Hz: first "
          f"{times[0]:.3f} s ({freqs.size / times[0]:.1f} solves/s), steady "
          f"{times[1]:.3f} s ({rec['solves_per_s_steady']:.1f} solves/s); "
          f"peak device memory {peak_gb:.2f} GB; K1 launches {rec['k1']}",
          flush=True)
    if fr.shape != freqs.shape or not np.all(np.isfinite(fr)):
        raise AssertionError(f"{label}: bad FRF: shape {fr.shape}, "
                             f"finite={np.all(np.isfinite(fr))}")
    return rec | {"fr": fr}


def oracle_check(p, freqs, fr, idx, label: str) -> float:
    """Worst relative error of ``fr`` at ``idx`` against the host f64 splu
    oracle; prints it and raises above ORACLE_TOL."""
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    worst = float(rel.max())
    print(f"[dense] {label}: rel err vs f64 splu at "
          + ", ".join(f"{freqs[i]:.3f} Hz {r:.3e}" for i, r in zip(idx, rel))
          + f"; worst {worst:.3e} (tol {ORACLE_TOL})", flush=True)
    if not worst <= ORACLE_TOL:
        raise AssertionError(f"{label}: worst rel err {worst:.3e} > "
                             f"{ORACLE_TOL}")
    return worst


def construct(dev, refine: float, label: str, **kw):
    """Build a Problem and its core on ``dev``; print its [dense] ctor line
    (the dense f64 inverse's build time is part of the construction)."""
    import torch

    t0 = time.perf_counter()
    p = sh_i_problem(dev, refine, **kw)
    od = p.getFRCore()[1]
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    lay = p._band_layout
    inv = od["invK64"]
    inv_mb = inv.numel() * inv.element_size() / 1e6
    print(f"[dense] {label}: n_free={p.n_free} nnz={p.op.pattern.nnz} "
          f"tier {p._tier} (layout, preconditioner, f32 basis)"
          + ("" if lay is None else f", b={lay.b} nb={lay.nb}")
          + f", m={od['W64'].shape[1]}; construction {ctor_s:.2f} s, of "
          f"which the dense f64 inverse (inv_refined, {inv_mb:.0f} MB) "
          f"{p._inv_build_s:.3f} s", flush=True)
    return p, {"n_free": p.n_free, "nnz": int(p.op.pattern.nnz),
               "tier": list(p._tier), "ctor_s": ctor_s,
               "inv_build_s": p._inv_build_s, "inv_mb": inv_mb}


def dense_tier(dev) -> dict:
    """Phase 7: the dense-preconditioner tier at n = 1466 (the bench
    configuration, forward and inverse) and n = 11910 (its largest plate).
    Returns the numbers for [summary], K1's zero counts under "k1"."""
    import plate_inverse_problem_tpu_torch as pt

    freqs = np.linspace(40.0, 600.0, N_FREQ)
    out = {}
    # ---- (a) the bench configuration -------------------------------------
    p, rec = construct(dev, 1.0, "(a) bench sh_i refine=1")
    if p._tier != ("flat", "dense", True):
        raise AssertionError(f"'auto' at n={p.n_free} resolved to {p._tier},"
                             " not the flat layout, the dense "
                             "preconditioner and an f32 basis")
    rec |= timed_sweeps(p, freqs, "(a) bench sweep")
    fr = rec.pop("fr")
    checksum = float(np.abs(fr).sum())
    cs_rel = abs(checksum - BENCH_CHECKSUM) / BENCH_CHECKSUM
    print(f"[dense] (a) FRF checksum sum |FRF| = {checksum!r} against the JAX "
          f"CPU run's {BENCH_CHECKSUM!r}: rel {cs_rel:.3e} (tol "
          f"{CHECKSUM_TOL})", flush=True)
    if not cs_rel <= CHECKSUM_TOL:
        raise AssertionError(f"bench checksum {checksum} is {cs_rel:.3e} from"
                             f" {BENCH_CHECKSUM}")
    # bench.py's four points (bench.py:261)
    idx = [3, int(np.argmax(fr)), N_FREQ // 2, N_FREQ - 1]
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "(a) bench points")
    rec["checksum"] = checksum
    # the same Problem data with an f64 Krylov basis: recorded only
    q = pt.Problem(p.geometry, p.material, p.accelerometer, device=dev,
                   basis_f32=False, opdata=p.getFRCore()[1])
    f64 = timed_sweeps(q, freqs, "(a) bench sweep, basis_f32=False")
    rec["basis_f64"] = {k: f64[k] for k in ("sweep_steady_s",
                                           "solves_per_s_steady", "k1")}
    rec["basis_f64"]["worst_rel_err"] = oracle_check(
        q, freqs, f64["fr"], idx, "(a) bench points, basis_f32=False")
    del q
    out["bench"] = rec

    # ---- (b) the inverse half on the bench Problem ------------------------
    out["bench_inverse"] = inverse_half(p, freqs, fr, k1=False,
                                        tag="[dense] (b) ")
    del p

    # ---- (c) the largest dense-tier plate --------------------------------
    p, rec = construct(dev, 3.0, "(c) sh_i refine=3")
    if p._tier != ("band", "dense", True):
        raise AssertionError(f"'auto' at n={p.n_free} resolved to {p._tier},"
                             " not the band layout with the dense "
                             "preconditioner")
    rec |= timed_sweeps(p, freqs, "(c) sweep")
    fr = rec.pop("fr")
    idx = [3, int(np.argmax(fr)), N_FREQ // 2, N_FREQ - 1]
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "(c) 4 points incl. the peak")
    rec["f_peak"] = float(freqs[idx[1]])
    out["largest"] = rec
    del p

    inv = out["bench_inverse"]
    out["k1"] = {"dense_sweep_1466": out["bench"]["k1"],
                 "dense_sweep_1466_basis_f64": out["bench"]["basis_f64"]["k1"],
                 "dense_rj_primal_1466": inv["k1_rj_primal"],
                 "dense_rj_adjoint_1466": inv["k1_rj_adjoint"],
                 "dense_gn_1466": inv["k1_gn"],
                 "dense_sweep_11910": out["largest"]["k1"]}
    if any(out["k1"].values()):
        raise AssertionError(f"K1 launched on the dense tier: {out['k1']}")
    return out


def launch_counter(fn, counts, key):
    """``fn`` with K1's launches inside each call added to counts[key]."""
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    def run(*a):
        n0 = band_kernel.band_mv_f32_cuda.launches
        out = fn(*a)
        counts[key] += band_kernel.band_mv_f32_cuda.launches - n0
        return out

    return run


def inverse_half(p, freqs, fr_truth, k1: bool = True, tag: str = "") -> dict:
    """Phase 6 on the Problem of phases 4-5 (and on the dense tier's in
    phase 7): the adjoint r + J, its checks and Gauss-Newton from theta_0.
    ``k1``: the tier runs the two-grid, so K1 must launch in both sweeps
    and in GN; else it must not launch at all.  ``tag`` prefixes the
    printed lines.  Returns the numbers for [summary]."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel

    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(START)
    core = p.getFRCore()[0]
    rf = p.getResidualFunction(freqs, fr_truth, kind="log_afc")

    # ---- [adjoint] one r + J, first and steady, K1 launches per sweep ----
    counts = {"primal": 0, "adjoint": 0}
    hooks = core.sweep_u, core.sweep_adj
    core.sweep_u = launch_counter(hooks[0], counts, "primal")
    core.sweep_adj = launch_counter(hooks[1], counts, "adjoint")
    times = []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(2):
            counts.update(primal=0, adjoint=0)
            band_kernel.band_mv_f32_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, J = rf.value_and_jac(th0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            total = band_kernel.band_mv_f32_cuda.launches
    finally:
        core.sweep_u, core.sweep_adj = hooks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r, J = r.cpu().numpy(), J.cpu().numpy()
    print(f"{tag}[adjoint] log_afc r + J at theta_0 = truth x {START}, "
          f"{freqs.size} points: first {times[0]:.3f} s, steady "
          f"{times[1]:.3f} s; K1 launches {counts['primal']} in the primal "
          f"sweep, {counts['adjoint']} in the adjoint sweep ({total} in "
          f"all); peak device memory {peak_gb:.2f} GB", flush=True)
    # every check of the phase runs after all of its measurements
    failed = []
    if k1 and (counts["primal"] <= 0 or counts["adjoint"] <= 0):
        failed.append(f"K1 not launched in both sweeps: {counts}")
    if not k1 and total != 0:
        failed.append(f"K1 launched {total} times on a tier without it")
    if total != counts["primal"] + counts["adjoint"]:
        failed.append(f"K1 launched outside the sweeps: {total} vs {counts}")
    if r.shape != (freqs.size,) or J.shape != (freqs.size, truth.size) \
            or not (np.all(np.isfinite(r)) and np.all(np.isfinite(J))):
        raise AssertionError(f"bad r {r.shape} or J {J.shape}")

    # ---- [jac] (a) against the loss gradient, (b) against differences ---
    loss = p.getLossFunction(freqs, fr_truth, "MSE_LOG_AFC")
    t0 = time.perf_counter()
    g = loss.grad(th0).cpu().numpy()
    grad_s = time.perf_counter() - t0
    g2 = loss.grad(th0).cpu().numpy()      # the same call again: its noise
    g_gn = 2.0 * J.T @ r / r.size
    grad_rel = float(np.abs(g_gn - g).max() / np.abs(g).max())
    grad_rerun = float(np.abs(g2 - g).max() / np.abs(g).max())
    print(f"{tag}[jac] (a) 2 J^T r / m vs MSE_LOG_AFC grad ({grad_s:.3f} s): "
          f"max rel {grad_rel:.3e} (tol {GRAD_TOL}); two grad calls differ "
          f"by {grad_rerun:.3e}", flush=True)

    def fd_dev(j, step):
        e = np.zeros(truth.size)
        e[j] = step * th0[j]
        fd = (rf(th0 + e) - rf(th0 - e)).cpu().numpy() / (2.0 * e[j])
        return float(np.abs(fd - J[:, j]).max() / np.abs(J[:, j]).max())

    fd_rel = [fd_dev(j, step) for j, step in enumerate(FD_STEPS)]
    fd_beta_1e4 = fd_dev(truth.size - 1, 1e-4)
    print(f"{tag}[jac] (b) J columns vs central differences at relative steps "
          f"{FD_STEPS}: max dev / column max "
          f"{', '.join(f'{x:.3e}' for x in fd_rel)} (tol {FD_TOL}); the beta "
          f"column at step 1e-4: {fd_beta_1e4:.3e}", flush=True)
    if not grad_rel <= GRAD_TOL:
        failed.append(f"2 J^T r / m disagrees with the loss gradient: "
                      f"{grad_rel:.3e} > {GRAD_TOL}")
    if not max(fd_rel) <= FD_TOL:
        failed.append(f"J disagrees with central differences: {fd_rel} > "
                      f"{FD_TOL}")
    # ---- [gn] Gauss-Newton through solveInverse --------------------------
    stamps = []
    make = p.getResidualFunction

    def timed_residuals(*a, **k):
        res_fn = make(*a, **k)
        vj = res_fn.value_and_jac

        def value_and_jac(x):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return vj(x)

        res_fn.value_and_jac = value_and_jac
        return res_fn

    p.getResidualFunction = timed_residuals
    band_kernel.band_mv_f32_cuda.launches = 0
    try:
        res = p.solveInverse(th0, "MSE_LOG_AFC", "gn",
                             ref_fr=(freqs, fr_truth), use_scaling=True,
                             N_steps=GN_STEPS, report=False, log=False)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    finally:
        del p.getResidualFunction
    k1_gn = band_kernel.band_mv_f32_cuda.launches
    iter_s = list(np.diff(stamps))
    for k, (f, x, s) in enumerate(zip(res.f_history, res.x_history, iter_s)):
        x = np.asarray(x) * th0
        print(f"{tag}[gn] iterate {k}: loss {f:.6e}  {s:.3f} s  rel err "
              f"{', '.join(f'{v:+.3e}' for v in (x - truth) / truth)}",
              flush=True)
    err = (np.abs(res.x) - truth) / truth
    print(f"{tag}[gn] {len(res.f_history)} iterations in {sum(iter_s):.3f} s "
          f"({np.mean(iter_s):.3f} s/iter), status {res.status}, K1 "
          f"launches {k1_gn}; result rel err (|beta|) "
          f"{', '.join(f'{v:+.3e}' for v in err)} (tol {GN_TOL})", flush=True)
    if k1 and k1_gn <= 0:
        failed.append("Gauss-Newton never launched the band kernel")
    if not k1 and k1_gn != 0:
        failed.append(f"Gauss-Newton launched K1 {k1_gn} times on a tier "
                      "without it")
    if not np.all(np.diff(res.f_history) < 0):
        failed.append(f"loss did not fall at every step: {res.f_history}")
    if not np.all(np.abs(err) <= GN_TOL):
        failed.append(f"GN result {res.x} is not within {GN_TOL} of the "
                      f"truth {truth}")
    if failed:
        raise AssertionError(f"{tag or 'phase 6 '}failed: "
                             + "; ".join(failed))
    return {"rj_first_s": times[0], "rj_steady_s": times[1],
            "k1_rj_primal": counts["primal"],
            "k1_rj_adjoint": counts["adjoint"], "rj_peak_mem_gb": peak_gb,
            "grad_s": grad_s, "jac_grad_rel": grad_rel,
            "grad_rerun_rel": grad_rerun, "jac_fd_rel": fd_rel,
            "jac_fd_beta_step_1e-4": fd_beta_1e4,
            "gn_f_history": [float(f) for f in res.f_history],
            "gn_iter_s": iter_s, "gn_s_per_iter": float(np.mean(iter_s)),
            "gn_status": res.status, "gn_rel_err": [float(v) for v in err],
            "k1_gn": k1_gn}


if __name__ == "__main__":
    sys.exit(main())
