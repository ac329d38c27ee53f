#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path once at a real size — the 21k-DOF band tier
(``sh_i`` strip, refine = 4, isotropic steel, AP1030, 512 frequencies over
40-600 Hz) through ``Problem(...).solveForward`` on ``cuda`` — and checks it:

1. a CUDA device is present; print the card's name and power limit;
2. build the hand-written band kernel (``csrc/band_mv.cu``) with nvcc;
3. hold the kernel against its plain torch version on the card, at the
   slice's own shape and at a synthetic b = 64 block size, to 1e-5 of
   max |y| (the f32 sums of 3b terms run in another order), and time both;
4. run the 512-point sweep, count the kernel's launches (must be > 0) and
   check that the FRF is finite;
5. hold the FRF against a host f64 sparse-LU oracle at 4 points including
   the |FRF| peak, to 1e-6 relative.

Any failed phase raises and the script exits non-zero.  The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_FREQ = 512
KERNEL_TOL = 1e-5
ORACLE_TOL = 1e-6


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernel(band, x, layout, label: str) -> dict:
    """Kernel vs plain version on the same inputs: errors and times."""
    import torch
    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        band_mv_f32_cuda, band_mv_f32_reference)

    y_ref = band_mv_f32_reference(band, x, layout)
    y = band_mv_f32_cuda(band, x, layout)
    torch.cuda.synchronize()
    max_abs = float((y - y_ref).abs().max())
    rel = max_abs / max(float(y_ref.abs().max()), 1e-30)
    # in turns: plain, kernel, kernel, plain
    t_plain = [time_ms(lambda: band_mv_f32_reference(band, x, layout))]
    t_kern = [time_ms(lambda: band_mv_f32_cuda(band, x, layout))]
    t_kern.append(time_ms(lambda: band_mv_f32_cuda(band, x, layout)))
    t_plain.append(time_ms(lambda: band_mv_f32_reference(band, x, layout)))
    rec = {"max_abs_err": max_abs, "rel_err": rel,
           "ms": float(np.mean(t_kern)), "plain_ms": float(np.mean(t_plain))}
    print(f"[kernel] {label}: B={x.reshape(-1, layout.n).shape[0]} "
          f"nb={layout.nb} b={layout.b} n={layout.n}  max|dy|={max_abs:.3e} "
          f"rel={rel:.3e}  kernel {rec['ms']:.4f} ms  plain "
          f"{rec['plain_ms']:.4f} ms", flush=True)
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"band kernel disagrees at {label}: rel {rel:.3e}"
                             f" > {KERNEL_TOL}")
    return rec


def synthetic_b64(device):
    """The b = 64 narrow-band pattern of tests/test_band.py:203-213."""
    import torch
    from plate_inverse_problem_tpu_torch.ops.band import (
        build_band_layout, flat_to_band)

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
    return band, x, layout


def main() -> int:
    import torch

    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); nothing was run.")
    card = card_info()
    print(card, flush=True)   # as nvidia-smi gives it: "<name>, <limit> W"
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smoke(torch.device("cuda"), card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def smoke(dev, card: str):
    """Phases 2-5 on ``dev``; prints the kernels' JSON record last."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import band_kernel
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    # ---- 2. build the kernel ---------------------------------------------
    t0 = time.perf_counter()
    report = band_kernel.build()
    print(f"[build] band_mv.cu -> sm_90a in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in report.splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}", flush=True)

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

    # ---- 3. kernel vs plain version on the card ----------------------------
    chunk = p._auto_freq_chunk() or N_FREQ
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.standard_normal((chunk, 2, p.n_free)).astype(np.float32),
        device=dev)
    slice_rec = compare_kernel(od["mg_band0"], x, lay,
                               "slice (21k K_ref band, f32)")
    compare_kernel(*synthetic_b64(dev), "synthetic b=64")

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

    print(f"[summary] {json.dumps({'card': card, 'n_free': p.n_free, 'ctor_s': ctor_s, 'sweep_first_s': sweep_s, 'sweep_steady_s': steady_s, 'solves_per_s_steady': N_FREQ / steady_s, 'peak_mem_gb': peak_gb, 'worst_rel_err': worst, 'f_peak': float(freqs[ipk])})}",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "band_mv_f32",
        "route": "cuda",
        "source": "plate_inverse_problem_tpu_torch/csrc/band_mv.cu",
        "replaces": "plate_inverse_problem_tpu/ops/pallas_band.py:75",
        "launches": launches,
        "max_abs_err": slice_rec["max_abs_err"],
        "ms": slice_rec["ms"],
        "plain_ms": slice_rec["plain_ms"],
    }]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
