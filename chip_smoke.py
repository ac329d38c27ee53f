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
5. hold the FRF against a host f64 sparse-LU oracle (``oracle.splu_frf``:
   an f64 LU solve refined with extended-precision residuals, the solution
   of the f64 system) at 4 points including the |FRF| peak, to 1e-6
   relative;
6. the inverse half on the same Problem, from theta_0 = truth x (1.05,
   1.02, 1.2) against the phase-4 FRF at the truth (``[adjoint]``,
   ``[jac]``, ``[gn]``): time ``ResidualFunction("log_afc").value_and_jac``
   (first and steady call) and count K1's launches in its primal and its
   adjoint sweep (both must be > 0); hold 2 J^T r / m against the
   MSE_LOG_AFC loss gradient (GRAD_TOL_21K; GRAD_TOL on the dense tier's
   n = 1466 in phase 7) and every column of J against a
   central difference of r (FD_STEPS, to FD_TOL of the column's max); run
   ``solveInverse(theta_0, "MSE_LOG_AFC", "gn", use_scaling=True,
   N_steps=GN_STEPS)``, print every iterate's loss and seconds, and
   require the loss to fall at every step and the result to reach the
   truth to 1e-4 relative (|beta|: the FRF magnitude is even in the loss
   factor, so -beta is an exact minimum too);
7. the dense-preconditioner tier (``[dense]``), where K1 must not run:
   (a) the bench configuration as ``bench.py`` builds it (``sh_i`` refine =
   1, n = 1466, ``precond`` and ``operator_layout`` left at "auto", which
   must resolve to the flat layout, the dense preconditioner and the
   port's f64 Krylov basis): a first and a steady 512-point sweep with peak
   memory, the FRF checksum sum |FRF| within 1e-6 of the JAX CPU run's
   (``BENCH_r05.json``) and the worst relative error against the host f64
   splu at bench.py's four points within 1e-6; one steady sweep with
   ``basis_f32=True`` (the JAX package's f32 basis) held to the same 1e-6;
   (b) phase 6's inverse half
   on that Problem; (c) the largest dense-tier plate (refine = 3, n =
   11910, "auto": the band layout with the dense preconditioner): its
   construction with the dense f64 inverse, a first and a steady sweep
   with peak memory, and the splu check at 4 points including the peak.
   K1's launch counter reads 0 over each of them;
8. the material families and the pure-bending path (``[families]``), all
   sweeps 512 points over 40-600 Hz: (a) the multi-cut orthotropic
   identification of ``examples/joint_identification.py`` on the bench
   plate (n = 1466, dense tier): three SOL cuts at 0/90/45 degrees sharing
   theta = [E1, E2, G12, nu12, beta], synthetic FRFs from ``solveForward``
   at the truth, a ``JointResidual`` of theta-scaled ``log_afc`` residuals
   and 30 Gauss-Newton steps from s0, every iterate's loss and seconds
   printed, the loss falling at every step and the result within
   JOINT_TOL of the truth; and a non-palindromic SOL stack (0, 45), whose
   B is not zero, against f64 splu at 4 points incl. the peak; (b)
   ``OrthotropicD4`` (a loss factor per modulus, so K_im is a third
   operator) at refine = 4 (n = 20916, two-grid): construction, a first
   and a steady sweep with peak memory, splu at 4 points incl. the peak,
   K1 launches > 0; one ``ResidualFunction("log_afc").value_and_jac`` over
   the 8 parameters with K1 launches in both sweeps, 2 J^T r / m against
   the MSE_LOG_AFC gradient; (c) isotropic steel on the pure-bending path
   (``Problem(geom, mat, None)``) at refine = 1 (n = 956, dense) and 4 (n
   = 13862, two-grid): construction, first and steady sweep, splu at 4
   points incl. the peak of the complex FRF; at 13862 K1 launches > 0 and
   K1 against its plain version on that Problem's own pack (a Morley-only
   band);
9. the flat-pattern operator K3 (``csrc/csr_mv.cu``, built beside K1 in
   phase 2) and the rest of the public API (``[slice6]``): (a) K3 against
   its plain version (the ``index_add_`` scatter) on the card at the
   main path's shapes — S = 2 operators on the bench pattern (n = 1466)
   at L = 1024 and 16 lanes, S = 3 there, the 290,688- and 513,552-nnz
   patterns of n = 11910 and 20916 at L = 1024, and the f32 variant — to
   CSR_TOL of max |y|, with its time, the plain version's, the time of
   one ``torch.sparse.mm`` on the same CSR (``library_ms``) and its bound;
   (b) two steady sweeps and two MSE_LOG_AFC gradients bit-identical at n
   = 1466 and on phase 6's 21k Problem; (c) the SOL 45 deg plate (n =
   1466) at s and s0 (theta / truth away from the build point): splu at 4
   points incl. the peak, and ``diagnoseSweep`` with every lane converged;
   (d) ``examples/tpu_benchmark.py``'s workflow: construction, a
   3000-point sweep first and steady, then ``solveInverse`` by gradient
   descent on 200 compressed points (as called there, and with
   ``use_scaling``) and by ``cd_mem`` with ``use_scaling`` for 5 cycles,
   every step's loss and seconds, each result within TPUB_TOL of the JAX
   package's CPU run of the same call (TPUB_JAX); (e)
   ``examples/edp_import.py``'s plate with a hole, built from its script
   text (``.edp``: clamped on label 2, read at its xtest/ytest, pure
   bending), its 121-point sweep against splu at 4 points incl. the peak.

Any failed phase raises and the script exits non-zero.  The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
(``--ab SOURCE``, repeatable, also builds another version of K1, with the
earlier dense-band or the packed C interface, and times it beside the
kernel in the tree, in turns.)
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_FREQ = 512
KERNEL_TOL = 1e-5
SLEEP_CYCLES = 20_000_000   # ~10 ms of device sleep ahead of a timed run
ORACLE_TOL = 1e-6
START = (1.05, 1.02, 1.2)     # theta_0 / truth of phase 6
# 2 J^T r / m vs the loss gradient, relative to its max component.  The two
# share the primal sweep and differ in their adjoint sweeps (the adjoint
# right-hand sides differ), each solved to the FGMRES tolerance.  Every
# operator apply now runs K3, which sums in one fixed order, so each sweep
# gives the same bits in every run (phase 9 (b) checks it) and the
# deviation is the two adjoint solves' own: at n = 1466 the CPU test
# (tests/test_torch_inverse.py) and the card hold it to 1e-8 (7.8e-10 on
# an H100 at 700 W).  At 21k it is the two-grid tier's solve tolerance,
# which moves with the random ARPACK basis of the Problem: 9.9e-8 with the
# deterministic K3 (OrthotropicD4: 1.6e-9), 7.7e-8 to 2.4e-7 in earlier
# runs with the atomic scatter, on an H100 at 700 W; GRAD_TOL_21K rounds
# that up.
GRAD_TOL = 1e-8
GRAD_TOL_21K = 3e-7
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
# phase 8 (a): examples/joint_identification.py on the bench plate —
# theta = [E1, E2, G12, nu12, beta] of a carbon-like sheet (density 1550),
# three SOL cuts, the start s0 = theta_0 / truth and the Gauss-Newton steps;
# the result's relative tolerance to the truth per parameter (|beta|: the
# FRF magnitude is even in the loss factor)
JOINT_TRUE = (120e9, 8.5e9, 4.5e9, 0.30, 0.006)
JOINT_ANGLES = (0.0, 90.0, 45.0)
JOINT_S0 = (1.35, 0.70, 1.40, 0.85, 1.50)
JOINT_STEPS = 30
JOINT_TOL = (1e-3, 1e-3, 1e-3, 1e-2, 1e-2)
# (the JAX package's own CPU run of this configuration,
# .probes/joint_identification_jax.py, meets JOINT_TOL: it stalls after 16
# steps at -7.6e-6, +2.7e-6, -1.1e-4, +2.7e-3, -5.6e-6)
# phase 8 (b): the per-modulus loss factors of tests/test_problem.py
D4 = dict(E1=210e9, E2=200e9, G12=75e9, nu12=0.33, b1=0.003, b2=0.003,
          b3=0.004, b4=0.0)
D4_START = (1.02, 0.98, 1.03, 0.97, 1.1, 0.9, 1.05, 1.0)   # theta_0 / truth
# phase 9 (a): K3 against its plain version, of max |y| (the f64 sums of a
# row run in another order and with FMAs; f32 as K1)
CSR_TOL = {"f64": 1e-12, "f32": 1e-5}
# H100 SXM rates the bound uses: memory, f64 and f32 FMAs on the CUDA cores
# (NVIDIA's data sheet; K3 uses no tensor cores)
HBM_BPS = 3.35e12
F64_FLOPS = 34e12
F32_FLOPS = 67e12
# phase 9 (c): theta / truth where ROADMAP's dense-tier fault showed
SOL45_S = (0.7, 1.3, 0.6, 1.15, 0.5)
# phase 9 (d): examples/tpu_benchmark.py's workflow, and the JAX package's
# own CPU run of the same calls (.probes/tpu_benchmark_jax.py, the
# package's default CPU engine: modal), (x, niter, status) per run
TPUB_N_FREQ = 3000
TPUB_N_COMP = 200
TPUB_START = (0.1, 0.1, 0.2)
TPUB_RUNS = {"gd": ("gd", 20, False), "gd_scaled": ("gd", 20, True),
             "cd_mem_scaled": ("cd_mem", 5, True)}
TPUB_JAX = {
    "gd": ((220000000000.00003, 82500000000.0, 0.054617256073671495), 19,
           "Running"),
    "gd_scaled": ((203958143447.65717, 92312934898.18619,
                   0.0043248574568596695), 19, "Running"),
    "cd_mem_scaled": ((229486910306.21732, 91518930001.49454,
                       0.004322571981818481), 4, "Running"),
}
TPUB_JAX_CHECKSUM = 9390.68402986405
TPUB_TOL = 1e-6
# phase 9 (e): the script of examples/edp_import.py
EDP_SCRIPT = """
// a plate with a circular hole, clamped on its RIGHT border (label 2 --
// note: not the templates' label 1; the on(...) clause below declares it)
real Lx = 90e-3; real Ly = 30e-3;
real r = 6e-3;
real xtest = 25e-3; real ytest = 5e-3;
int n = 8;
border Bl(t=0., 1){x=0;        y=Ly - t*Ly; label=0;}
border Bb(t=0., 1){x=Lx*t;     y=0;         label=0;}
border Br(t=0., 1){x=Lx;       y=t*Ly;      label=2;}
border Bt(t=0., 1){x=(1-t)*Lx; y=Ly;        label=0;}
border Hole(t=0., 2*pi){x=Lx/2 + r*cos(-t); y=Ly/2 + r*sin(-t); label=0;}
mesh Th = buildmesh(Bl(n) + Bb(3*n) + Br(n) + Bt(3*n) + Hole(2*n));
// the physics section is FreeFEM-specific and not interpreted -- but its
// on(...) labels ARE honored as the essential-BC location:
problem P(u, v) = ... + on(2, u=0, ux=0, uy=0);
"""


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
    """Phases 2-9 on ``dev``; prints the kernels' JSON record last.
    ``ab_sources``: other versions of K1 to time beside it (A/B only)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    # ---- 2. build the kernels, one nvcc each, both at once ----------------
    t_phases = t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = {name: pool.submit(fn) for name, fn in
                  (("band_mv.cu", band_kernel.build),
                   ("csr_mv.cu", csr_kernel.build))}
        reports = {name: f.result() for name, f in builds.items()}
    print(f"[build] band_mv.cu and csr_mv.cu -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, report in reports.items():
        for line in ptxas_summary(report):
            print(f"[build] {name}: {line}", flush=True)

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
    csr_kernel.csr_mv_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = p.solveForward(freqs)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = band_kernel.band_mv_f32_cuda.launches
    k3_sweep = csr_kernel.csr_mv_cuda.launches
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
          f"band kernel launches={launches}, K3 {k3_sweep}, peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    if launches <= 0:
        raise AssertionError("the sweep never launched the band kernel")
    if fr.shape != (N_FREQ,) or not np.all(np.isfinite(fr)):
        raise AssertionError(f"bad FRF: shape {fr.shape}, "
                             f"finite={np.all(np.isfinite(fr))}")

    # ---- 5. host f64 splu oracle at 4 points including the peak -----------
    idx = peak_points(fr)
    ipk = idx[1]
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

    inv = inverse_half(p, freqs, fr, grad_tol=GRAD_TOL_21K)
    dense = dense_tier(dev)
    fam = families(dev)
    s6 = slice6(dev, p, freqs, fr)

    summary = {"card": card, "n_free": p.n_free, "ctor_s": ctor_s,
               "pack_build_ms": 1e3 * p._pack_build_s,
               "pack_tiles": pack.vals.shape[0], "pack_mb": pack_mb,
               "sweep_first_s": sweep_s, "sweep_steady_s": steady_s,
               "solves_per_s_steady": N_FREQ / steady_s,
               "peak_mem_gb": peak_gb, "worst_rel_err": worst,
               "f_peak": float(freqs[ipk]), "k1_by_B": recs, "k1_b64": b64,
               **inv, "dense": dense, "families": fam,
               "slice6": {k: v for k, v in s6.items() if k != "k3"}}
    summary["phases_s"] = time.perf_counter() - t_phases
    print(f"[time] phases 2-9 in {summary['phases_s']:.1f} s", flush=True)
    k3_paths = {"sweep_21k": k3_sweep, "rj_21k": inv["k3_rj"],
                "grad_21k": inv["k3_grad"],
                "dense_sweep_1466": dense["bench"]["k3"],
                "rj_1466": dense["bench_inverse"]["k3_rj"],
                "grad_1466": dense["bench_inverse"]["k3_grad"],
                **s6["k3"]["by_path"]}
    if not all(v > 0 for v in k3_paths.values()):
        raise AssertionError(f"K3 launched no time on a path: {k3_paths}")
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
                             **dense["k1"], **fam["k1"]},
        "max_abs_err": slice_rec["max_abs_err"],
        "ms": slice_rec["ms"],
        "plain_ms": slice_rec["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": slice_rec["library_ms"],
    }, {
        "name": "csr_mv",
        "route": "cuda",
        "source": "plate_inverse_problem_tpu_torch/csrc/csr_mv.cu",
        "replaces": "plate_inverse_problem_tpu/ops/mixed.py:651 (not Pallas)",
        "launches": s6["k3"]["launches"],
        "launches_by_path": k3_paths,
        **{k: s6["k3"]["headline"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    }]}), flush=True)


def sh_i_problem(dev, refine: float, mat=None, accel: bool = True, **kw):
    """``sh_i`` strip 100 x 20 x 2 mm, AP1030 (bench.py's plate at refine =
    1), on ``dev``: isotropic steel unless ``mat`` is given; ``accel=False``
    leaves the accelerometer out of the Problem (the pure-bending path of a
    mid-plane symmetric material)."""
    import plate_inverse_problem_tpu_torch as pt

    acc = pt.Accelerometer("AP1030")
    if mat is None:
        mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                              beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=refine)
    return pt.Problem(geom, mat, acc if accel else None, device=dev, **kw)


def timed_sweeps(p, freqs, label: str, tag: str = "[dense]") -> dict:
    """A first and a steady sweep, synchronised, with the peak device memory
    of the first and K1's launches over both; prints one ``tag`` line."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.csr_mv_cuda.launches = 0
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
           "k1": band_kernel.band_mv_f32_cuda.launches,
           "k3": csr_kernel.csr_mv_cuda.launches}
    print(f"{tag} {label}: {freqs.size} points over 40-600 Hz: first "
          f"{times[0]:.3f} s ({freqs.size / times[0]:.1f} solves/s), steady "
          f"{times[1]:.3f} s ({rec['solves_per_s_steady']:.1f} solves/s); "
          f"peak device memory {peak_gb:.2f} GB; K1 launches {rec['k1']}, "
          f"K3 {rec['k3']}", flush=True)
    if fr.shape != freqs.shape or not np.all(np.isfinite(fr)):
        raise AssertionError(f"{label}: bad FRF: shape {fr.shape}, "
                             f"finite={np.all(np.isfinite(fr))}")
    return rec | {"fr": fr}


def peak_points(fr) -> list[int]:
    """bench.py's four points of a 512-point sweep: 3, the |FRF| peak, 256
    and 511."""
    return [3, int(np.argmax(np.abs(fr))), N_FREQ // 2, N_FREQ - 1]


def oracle_check(p, freqs, fr, idx, label: str, tag: str = "[dense]"
                 ) -> float:
    """Worst relative error of ``fr`` (real or complex) at ``idx`` against
    the host f64 splu oracle; prints it and raises above ORACLE_TOL."""
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    worst = float(rel.max())
    print(f"{tag} {label}: rel err vs f64 splu at "
          + ", ".join(f"{freqs[i]:.3f} Hz {r:.3e}" for i, r in zip(idx, rel))
          + f"; worst {worst:.3e} (tol {ORACLE_TOL})", flush=True)
    if not worst <= ORACLE_TOL:
        raise AssertionError(f"{label}: worst rel err {worst:.3e} > "
                             f"{ORACLE_TOL}")
    return worst


def construct(dev, refine: float, label: str, tag: str = "[dense]", **kw):
    """Build a Problem (``sh_i_problem`` keywords) and its core on ``dev``;
    print its ctor line: the dense f64 inverse's build time, or the
    two-grid's coarse size and K1 pack, is part of the construction."""
    import torch

    t0 = time.perf_counter()
    p = sh_i_problem(dev, refine, **kw)
    od = p.getFRCore()[1]
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    lay = p._band_layout
    rec = {"n_free": p.n_free, "nnz": int(p.op.pattern.nnz),
           "tier": list(p._tier), "ctor_s": ctor_s}
    if "invK64" in od:
        inv = od["invK64"]
        rec |= {"inv_build_s": p._inv_build_s,
                "inv_mb": inv.numel() * inv.element_size() / 1e6}
        part = (f"the dense f64 inverse (inv_refined, {rec['inv_mb']:.0f} "
                f"MB) {p._inv_build_s:.3f} s")
    else:
        rec |= {"n_c": p._mg_rl.n_coarse,
                "pack_tiles": p._band_pack.vals.shape[0],
                "pack_build_ms": 1e3 * p._pack_build_s}
        part = (f"the two-grid's coarse level n_c={rec['n_c']} and the K1 "
                f"pack ({rec['pack_tiles']} tiles, "
                f"{rec['pack_build_ms']:.1f} ms)")
    print(f"{tag} {label}: n_free={p.n_free} nnz={p.op.pattern.nnz} "
          f"tier {p._tier} (layout, preconditioner, f32 Krylov basis)"
          + ("" if lay is None else f", b={lay.b} nb={lay.nb}")
          + f", m={od['W64'].shape[1]}; construction {ctor_s:.2f} s, of "
          f"which {part}", flush=True)
    return p, rec


def dense_tier(dev) -> dict:
    """Phase 7: the dense-preconditioner tier at n = 1466 (the bench
    configuration, forward and inverse) and n = 11910 (its largest plate).
    Returns the numbers for [summary], K1's zero counts under "k1"."""
    import plate_inverse_problem_tpu_torch as pt

    freqs = np.linspace(40.0, 600.0, N_FREQ)
    out = {}
    # ---- (a) the bench configuration -------------------------------------
    p, rec = construct(dev, 1.0, "(a) bench sh_i refine=1")
    if p._tier != ("flat", "dense", False):
        raise AssertionError(f"'auto' at n={p.n_free} resolved to {p._tier},"
                             " not the flat layout, the dense "
                             "preconditioner and an f64 basis")
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
    idx = peak_points(fr)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "(a) bench points")
    rec["checksum"] = checksum
    # the same Problem data with the JAX package's f32 Krylov basis
    q = pt.Problem(p.geometry, p.material, p.accelerometer, device=dev,
                   basis_f32=True, opdata=p.getFRCore()[1])
    f32 = timed_sweeps(q, freqs, "(a) bench sweep, basis_f32=True")
    rec["basis_f32"] = {k: f32[k] for k in ("sweep_steady_s",
                                           "solves_per_s_steady", "k1")}
    rec["basis_f32"]["worst_rel_err"] = oracle_check(
        q, freqs, f32["fr"], idx, "(a) bench points, basis_f32=True")
    del q
    out["bench"] = rec

    # ---- (b) the inverse half on the bench Problem ------------------------
    out["bench_inverse"] = inverse_half(p, freqs, fr, k1=False,
                                        tag="[dense] (b) ")
    del p

    # ---- (c) the largest dense-tier plate --------------------------------
    p, rec = construct(dev, 3.0, "(c) sh_i refine=3")
    if p._tier != ("band", "dense", False):
        raise AssertionError(f"'auto' at n={p.n_free} resolved to {p._tier},"
                             " not the band layout with the dense "
                             "preconditioner")
    rec |= timed_sweeps(p, freqs, "(c) sweep")
    fr = rec.pop("fr")
    idx = peak_points(fr)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "(c) 4 points incl. the peak")
    rec["f_peak"] = float(freqs[idx[1]])
    out["largest"] = rec
    del p

    inv = out["bench_inverse"]
    out["k1"] = {"dense_sweep_1466": out["bench"]["k1"],
                 "dense_sweep_1466_basis_f32": out["bench"]["basis_f32"]["k1"],
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


def inverse_half(p, freqs, fr_truth, k1: bool = True, tag: str = "",
                 grad_tol: float = GRAD_TOL) -> dict:
    """Phase 6 on the Problem of phases 4-5 (and on the dense tier's in
    phase 7): the adjoint r + J, its checks and Gauss-Newton from theta_0.
    ``k1``: the tier runs the two-grid, so K1 must launch in both sweeps
    and in GN; else it must not launch at all.  ``tag`` prefixes the
    printed lines; ``grad_tol`` bounds 2 J^T r / m against the gradient.
    Returns the numbers for [summary]."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

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
            csr_kernel.csr_mv_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, J = rf.value_and_jac(th0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            total = band_kernel.band_mv_f32_cuda.launches
            k3_rj = csr_kernel.csr_mv_cuda.launches
    finally:
        core.sweep_u, core.sweep_adj = hooks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r, J = r.cpu().numpy(), J.cpu().numpy()
    print(f"{tag}[adjoint] log_afc r + J at theta_0 = truth x {START}, "
          f"{freqs.size} points: first {times[0]:.3f} s, steady "
          f"{times[1]:.3f} s; K1 launches {counts['primal']} in the primal "
          f"sweep, {counts['adjoint']} in the adjoint sweep ({total} in "
          f"all), K3 {k3_rj}; peak device memory {peak_gb:.2f} GB", flush=True)
    # every check of the phase runs after all of its measurements
    failed = []
    if k1 and (counts["primal"] <= 0 or counts["adjoint"] <= 0):
        failed.append(f"K1 not launched in both sweeps: {counts}")
    if not k1 and total != 0:
        failed.append(f"K1 launched {total} times on a tier without it")
    if total != counts["primal"] + counts["adjoint"]:
        failed.append(f"K1 launched outside the sweeps: {total} vs {counts}")
    if k3_rj <= 0:
        failed.append("r + J never launched K3")
    if r.shape != (freqs.size,) or J.shape != (freqs.size, truth.size) \
            or not (np.all(np.isfinite(r)) and np.all(np.isfinite(J))):
        raise AssertionError(f"bad r {r.shape} or J {J.shape}")

    # ---- [jac] (a) against the loss gradient, (b) against differences ---
    loss = p.getLossFunction(freqs, fr_truth, "MSE_LOG_AFC")
    csr_kernel.csr_mv_cuda.launches = 0
    t0 = time.perf_counter()
    g = loss.grad(th0).cpu().numpy()
    grad_s = time.perf_counter() - t0
    k3_grad = csr_kernel.csr_mv_cuda.launches
    g2 = loss.grad(th0).cpu().numpy()      # the same call again: its noise
    g_gn = 2.0 * J.T @ r / r.size
    grad_rel = float(np.abs(g_gn - g).max() / np.abs(g).max())
    grad_rerun = float(np.abs(g2 - g).max() / np.abs(g).max())
    print(f"{tag}[jac] (a) 2 J^T r / m vs MSE_LOG_AFC grad ({grad_s:.3f} s, "
          f"K3 {k3_grad}): max rel {grad_rel:.3e} (tol {grad_tol}); two grad "
          f"calls differ by {grad_rerun:.3e}", flush=True)

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
    if not grad_rel <= grad_tol:
        failed.append(f"2 J^T r / m disagrees with the loss gradient: "
                      f"{grad_rel:.3e} > {grad_tol}")
    if k3_grad <= 0:
        failed.append("the loss gradient never launched K3")
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
            "k3_rj": k3_rj, "k3_grad": k3_grad,
            "grad_s": grad_s, "jac_grad_rel": grad_rel,
            "grad_rerun_rel": grad_rerun, "jac_fd_rel": fd_rel,
            "jac_fd_beta_step_1e-4": fd_beta_1e4,
            "gn_f_history": [float(f) for f in res.f_history],
            "gn_iter_s": iter_s, "gn_s_per_iter": float(np.mean(iter_s)),
            "gn_status": res.status, "gn_rel_err": [float(v) for v in err],
            "k1_gn": k1_gn}


def families(dev) -> dict:
    """Phase 8: the material families and the pure-bending path, (a) the
    multi-cut orthotropic identification at n = 1466, (b) per-modulus loss
    factors at n = 20916, (c) the pure-bending path at n = 956 and 13862.
    Returns the numbers for [summary], K1's counts by path under "k1"."""
    out = {"joint": joint_identification(dev), "d4": per_modulus(dev),
           "symm": pure_bending(dev)}
    d4, symm = out["d4"], out["symm"]
    out["k1"] = {"families_joint_gn": out["joint"]["k1"],
                 "families_sol_0_45_sweep": out["joint"]["sol_0_45"]["k1"],
                 f"families_d4_sweep_{d4['n_free']}": d4["k1"],
                 f"families_d4_rj_primal_{d4['n_free']}": d4["k1_rj_primal"],
                 f"families_d4_rj_adjoint_{d4['n_free']}":
                     d4["k1_rj_adjoint"],
                 **{f"families_symm_sweep_{r['n_free']}": r["k1"]
                    for r in symm.values()}}
    return out


def joint_identification(dev) -> dict:
    """Phase 8 (a): examples/joint_identification.py on the bench plate,
    then a non-palindromic SOL stack against splu."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    tag = "[families] (a)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    truth = np.asarray(JOINT_TRUE)

    def sol(angles):
        return pt.get_material(1550.0, "sol", angles=angles, E1=truth[0],
                               E2=truth[1], G12=truth[2], nu12=truth[3],
                               beta=truth[4])

    band_kernel.band_mv_f32_cuda.launches = 0
    t0 = time.perf_counter()
    problems = [sh_i_problem(dev, 1.0, mat=sol((a,))) for a in JOINT_ANGLES]
    data = [p.solveForward(freqs, truth).cpu().numpy() for p in problems]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"{tag} {len(problems)} SOL cuts at {JOINT_ANGLES} deg, n_free="
          f"{problems[0].n_free}, tier {problems[0]._tier}: Problems and "
          f"synthetic FRFs at the truth in {setup_s:.2f} s", flush=True)
    joint = pt.JointResidual([
        p.getResidualFunction(freqs, fr, "log_afc", scaling_params=truth)
        for p, fr in zip(problems, data)])
    stamps = []
    value_and_jac = joint.value_and_jac

    def timed(s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return value_and_jac(s)

    joint.value_and_jac = timed
    res = pt.optimize_gauss_newton(joint, np.asarray(JOINT_S0),
                                   N_steps=JOINT_STEPS)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    k1 = band_kernel.band_mv_f32_cuda.launches
    iter_s = list(np.diff(stamps))
    for k, (f, x, s) in enumerate(zip(res.f_history, res.x_history, iter_s)):
        print(f"{tag} [gn] iterate {k}: loss {f:.6e}  {s:.3f} s  rel err "
              f"{', '.join(f'{v:+.3e}' for v in np.asarray(x) - 1.0)}",
              flush=True)
    err = (np.abs(res.x * truth) - truth) / truth
    print(f"{tag} [gn] {len(res.f_history)} iterations in {sum(iter_s):.3f} "
          f"s ({np.mean(iter_s):.3f} s/iter), status {res.status}, K1 "
          f"launches {k1}; result rel err (|beta|) "
          f"{', '.join(f'{v:+.3e}' for v in err)} (tol {JOINT_TOL})",
          flush=True)
    failed = []
    if k1 != 0:
        failed.append(f"K1 launched {k1} times on the dense tier")
    if not np.all(np.diff(res.f_history) < 0):
        failed.append(f"loss did not fall at every step: {res.f_history}")
    if not np.all(np.abs(err) <= np.asarray(JOINT_TOL)):
        failed.append(f"result {res.x * truth} is not within {JOINT_TOL} of "
                      f"the truth {truth}")

    # a non-palindromic stack: the 3-field path with B != 0
    band_kernel.band_mv_f32_cuda.launches = 0
    p = sh_i_problem(dev, 1.0, mat=sol((0.0, 45.0)))
    rec = timed_sweeps(p, freqs, "SOL (0, 45) sweep", tag)
    fr = rec.pop("fr")
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, peak_points(fr),
                                        "SOL (0, 45), 4 points incl. the "
                                        "peak", tag)
    rec["is_mps"] = bool(p.material.is_mps)
    if rec["k1"] != 0 or rec["is_mps"]:
        failed.append(f"SOL (0, 45): K1 {rec['k1']} (must be 0), is_mps "
                      f"{rec['is_mps']} (must be False)")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return {"setup_s": setup_s, "f_history": [float(f) for f in
                                              res.f_history],
            "iter_s": iter_s, "s_per_iter": float(np.mean(iter_s)),
            "status": res.status, "s_final": [float(v) for v in res.x],
            "rel_err": [float(v) for v in err], "k1": k1, "sol_0_45": rec}


def per_modulus(dev) -> dict:
    """Phase 8 (b): OrthotropicD4 on the two-grid tier (n = 20916): sweeps,
    splu, and the adjoint r + J over its 8 parameters."""
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    tag = "[families] (b)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    mat = pt.get_material(7920.0, "orthotropic_d4", **D4)
    p, rec = construct(dev, 4.0, "OrthotropicD4 sh_i refine=4", tag, mat=mat)
    if p._tier != ("band", "mg", False) or p.material.scalar_loss_factor:
        raise AssertionError(f"{tag}: tier {p._tier}, scalar loss factor "
                             f"{p.material.scalar_loss_factor}")
    rec |= timed_sweeps(p, freqs, "sweep", tag)
    fr = rec.pop("fr")
    idx = peak_points(fr)
    rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                        "4 points incl. the peak", tag)
    rec["f_peak"] = float(freqs[idx[1]])

    # the adjoint r + J over the 8 parameters, in variables scaled to O(1)
    # (b4 = 0 is scaled by 1e-3), with K1 counted in each sweep
    truth = np.asarray(p.parameters, np.float64)
    scale = np.where(truth != 0.0, truth, 1e-3)
    x0 = truth * np.asarray(D4_START) / scale
    rf = p.getResidualFunction(freqs, fr, kind="log_afc",
                               scaling_params=scale)
    core = p.getFRCore()[0]
    counts = {"primal": 0, "adjoint": 0}
    hooks = core.sweep_u, core.sweep_adj
    core.sweep_u = launch_counter(hooks[0], counts, "primal")
    core.sweep_adj = launch_counter(hooks[1], counts, "adjoint")
    times = []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(2):
            counts.update(primal=0, adjoint=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, J = rf.value_and_jac(x0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        core.sweep_u, core.sweep_adj = hooks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r, J = r.cpu().numpy(), J.cpu().numpy()
    loss = p.getLossFunction(freqs, fr, "MSE_LOG_AFC", scaling_params=scale)
    t0 = time.perf_counter()
    g = loss.grad(x0).cpu().numpy()
    grad_s = time.perf_counter() - t0
    g_gn = 2.0 * J.T @ r / r.size
    grad_rel = float(np.abs(g_gn - g).max() / np.abs(g).max())
    print(f"{tag} [adjoint] log_afc r + J over {truth.size} parameters at "
          f"theta_0 = truth x {D4_START}: first {times[0]:.3f} s, steady "
          f"{times[1]:.3f} s; K1 launches {counts['primal']} in the primal "
          f"sweep, {counts['adjoint']} in the adjoint sweep; peak device "
          f"memory {peak_gb:.2f} GB; 2 J^T r / m vs MSE_LOG_AFC grad "
          f"({grad_s:.3f} s): max rel {grad_rel:.3e} (tol {GRAD_TOL_21K})",
          flush=True)
    failed = []
    if rec["k1"] <= 0 or counts["primal"] <= 0 or counts["adjoint"] <= 0:
        failed.append(f"K1 not launched on every path: sweep {rec['k1']}, "
                      f"r + J {counts}")
    if J.shape != (freqs.size, truth.size) or not (
            np.all(np.isfinite(r)) and np.all(np.isfinite(J))):
        failed.append(f"bad r {r.shape} or J {J.shape}")
    if not grad_rel <= GRAD_TOL_21K:
        failed.append(f"2 J^T r / m disagrees with the loss gradient: "
                      f"{grad_rel:.3e} > {GRAD_TOL_21K}")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return rec | {"rj_first_s": times[0], "rj_steady_s": times[1],
                  "k1_rj_primal": counts["primal"],
                  "k1_rj_adjoint": counts["adjoint"],
                  "rj_peak_mem_gb": peak_gb, "grad_s": grad_s,
                  "jac_grad_rel": grad_rel}


def pure_bending(dev) -> dict:
    """Phase 8 (c): isotropic steel without an accelerometer, the
    pure-bending path, at n = 956 (dense tier) and 13862 (two-grid, with K1
    held against its plain version on the Problem's own pack)."""
    tag = "[families] (c)"
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    out = {}
    for refine, tier in ((1.0, ("flat", "dense", False)),
                         (4.0, ("band", "mg", False))):
        p, rec = construct(dev, refine, f"pure bending sh_i refine="
                           f"{refine:g}", tag, accel=False)
        if not p.is_symmetric_path or p._tier != tier:
            raise AssertionError(f"{tag}: symmetric path "
                                 f"{p.is_symmetric_path}, tier {p._tier}")
        if tier[1] == "mg":
            # K1 at the path's own pack: the Morley-only band, all the
            # sweep's lanes (re and im rows) in one batch
            import torch

            chunk = p._auto_freq_chunk() or N_FREQ
            rng = np.random.default_rng(1)
            x = torch.as_tensor(rng.standard_normal(
                (2 * chunk, p.n_free)).astype(np.float32), device=dev)
            rec["k1_pack"] = compare_kernel(
                p._band_pack, p.getFRCore()[1]["mg_band0"], x,
                p._band_layout, f"pure-bending pack ({p.n_free} Morley band,"
                " f32)")
            bound, bound_by = bound_ms(p._band_pack, x.shape[0], p.n_free)
            rec["k1_pack"] |= {"bound_ms": bound, "bound_by": bound_by}
            print(f"[bound] pure-bending pack B={x.shape[0]}: "
                  f"{1e3 * bound:.2f} us ({bound_by}); kernel at "
                  f"{100 * bound / rec['k1_pack']['ms']:.1f} % of it",
                  flush=True)
        rec |= timed_sweeps(p, freqs, "sweep", tag)
        fr = rec.pop("fr")
        if not np.iscomplexobj(fr):
            raise AssertionError(f"{tag}: the pure-bending FRF is not complex")
        idx = peak_points(fr)
        rec["worst_rel_err"] = oracle_check(p, freqs, fr, idx,
                                            "4 points incl. the peak", tag)
        rec["f_peak"] = float(freqs[idx[1]])
        if (rec["k1"] > 0) != (tier[1] == "mg"):
            raise AssertionError(f"{tag}: K1 launched {rec['k1']} times at "
                                 f"n={p.n_free}, tier {p._tier}")
        out[tier[1]] = rec
        del p
    return out


# ---------------------------------------------------------------------------
# phase 9: K3 and the rest of the public API
# ---------------------------------------------------------------------------

def csr_bound_ms(csr, S: int, L: int, itemsize: int) -> tuple[float, str]:
    """Least time of S operators on the pattern applied to L lanes on an
    H100 SXM: the S x nnz values with a 4-byte column index each and the
    row pointer, x read once and y written once, at HBM_BPS, against 2
    FLOP a nonzero, operator and lane at the CUDA cores' f64 (F64_FLOPS)
    or f32 (F32_FLOPS) rate."""
    n, nnz = csr.n, csr.nnz
    t_bytes = (S * nnz * itemsize + 4 * nnz + 4 * (n + 1)
               + (1 + S) * L * n * itemsize) / HBM_BPS
    t_ops = 2.0 * S * nnz * L / (F64_FLOPS if itemsize == 8 else F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare_csr(csr, S: int, L: int, dtype: str, label: str,
                seed: int) -> dict:
    """K3 vs its plain version on random data (S, nnz) and x (L, n) from a
    numpy seed on the pattern ``csr``; two launches must agree bit for bit.
    Device times of the kernel (its x transpose included), the plain
    version and the library call (one ``torch.sparse.mm`` of the S
    operators stacked as one (S n, n) CSR matrix on x^T, given x^T), in
    turns; the kernel also with the L2 flushed."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    tdt = torch.float64 if dtype == "f64" else torch.float32
    dev = csr.col.device
    n, nnz = csr.n, csr.nnz
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.standard_normal((S, nnz)), dtype=tdt,
                           device=dev)
    x = torch.as_tensor(rng.standard_normal((L, n)), dtype=tdt, device=dev)
    seg = 1 << 17     # the plain version's (S, L, seg) contribution tensor

    y_ref = ck.csr_mv_reference(data, x, csr, seg)
    y = ck.csr_mv_cuda(data, x, csr)
    same = bool(torch.equal(y, ck.csr_mv_cuda(data, x, csr)))
    d = (data if csr.perm is None else data[:, csr.perm]).reshape(-1)
    crow = torch.cat([csr.rowptr[:-1].long() + s * nnz for s in range(S)]
                     + [torch.tensor([S * nnz], device=dev)])
    A = torch.sparse_csr_tensor(crow, csr.col.long().repeat(S), d,
                                size=(S * n, n))
    xt = x.t().contiguous()
    y_lib = torch.sparse.mm(A, xt).reshape(S, n, L).transpose(1, 2)
    torch.cuda.synchronize()
    scale = max(float(y_ref.abs().max()), 1e-300)
    max_abs = float((y - y_ref).abs().max())
    lib_rel = float((y_lib - y_ref).abs().max()) / scale
    variants = {"ms": lambda: ck.csr_mv_cuda(data, x, csr),
                "plain_ms": lambda: ck.csr_mv_reference(data, x, csr, seg),
                "library_ms": lambda: torch.sparse.mm(A, xt)}
    order = list(variants) + list(variants)[::-1]
    times = {k: [] for k in variants}
    for k in order:
        times[k].append(time_ms(variants[k], reps=10)[0])
    rec = {k: float(np.mean(v)) for k, v in times.items()}
    bound, bound_by = csr_bound_ms(csr, S, L, 8 if dtype == "f64" else 4)
    rec.update(label=label, S=S, L=L, n=n, nnz=nnz, dtype=dtype,
               max_abs_err=max_abs, rel_err=max_abs / scale,
               library_rel_err=lib_rel, deterministic=same,
               flushed_ms=time_flushed_ms(variants["ms"], reps=10),
               bound_ms=bound, bound_by=bound_by)
    print(f"[slice6] (a) K3 {label}: {dtype} S={S} L={L} n={n} nnz={nnz}  "
          f"max|dy|={max_abs:.3e} rel={rec['rel_err']:.3e} (tol "
          f"{CSR_TOL[dtype]}), two launches identical: {same}  kernel "
          f"{rec['ms']:.4f} ms (L2 flushed {rec['flushed_ms']:.4f})  plain "
          f"{rec['plain_ms']:.4f} ms  library (torch.sparse.mm) "
          f"{rec['library_ms']:.4f} ms (rel {lib_rel:.1e})  bound "
          f"{bound:.4f} ms ({bound_by}), kernel at "
          f"{100 * bound / rec['ms']:.1f} % of it", flush=True)
    if not rec["rel_err"] <= CSR_TOL[dtype] or not same:
        raise AssertionError(f"K3 disagrees at {label}: rel "
                             f"{rec['rel_err']:.3e}, identical {same}")
    return rec


def k3_cases(p21) -> dict:
    """Phase 9 (a): K3 at the main path's shapes on three patterns: the
    bench plate's (n = 1466), n = 11910's and the 21k plate's (phase 6's
    Problem, its flat pattern in the band layout's order)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.csr_kernel import build_csr

    dev = torch.device("cuda")

    def pattern(p):
        rows = torch.as_tensor(p.op.pattern.rows, device=dev)
        cols = torch.as_tensor(p.op.pattern.cols, device=dev)
        return build_csr(rows, cols, p.n_free)

    bench = pattern(sh_i_problem(dev, 1.0))
    mid = pattern(sh_i_problem(dev, 3.0))
    od = p21.getFRCore()[1]
    big = build_csr(od["rows"], od["cols"], p21.n_free)
    cases = [(bench, 2, 1024, "f64", "bench S=2 L=1024"),
             (bench, 2, 16, "f64", "bench S=2 L=16 (Rayleigh-Ritz)"),
             (bench, 3, 1024, "f64", "bench S=3 (with K_im)"),
             (mid, 2, 1024, "f64", "n=11910 S=2"),
             (big, 2, 1024, "f64", "n=20916 S=2 (residual map)"),
             (bench, 1, 1024, "f32", "bench f32 S=1 (refinement)")]
    recs = [compare_csr(c, S, L, dt, label, seed)
            for seed, (c, S, L, dt, label) in enumerate(cases)]
    return {"cases": recs, "headline": recs[0]}


def determinism(p, freqs, fr_ref, label: str) -> dict:
    """Phase 9 (b): two steady sweeps and two MSE_LOG_AFC gradients (at
    theta_0 = truth x START against ``fr_ref``) on ``p`` are bit-identical."""
    th0 = np.asarray(p.parameters, np.float64) * np.asarray(START)
    sweeps = [p.solveForward(freqs).cpu().numpy() for _ in range(3)][1:]
    loss = p.getLossFunction(freqs, fr_ref, "MSE_LOG_AFC")
    grads = [loss.grad(th0).cpu().numpy() for _ in range(2)]
    rec = {"sweeps_identical": bool(np.array_equal(*sweeps)),
           "grads_identical": bool(np.array_equal(*grads)),
           "sweep_max_diff": float(np.abs(sweeps[0] - sweeps[1]).max()),
           "grad_max_diff": float(np.abs(grads[0] - grads[1]).max())}
    print(f"[slice6] (b) {label}: two steady sweeps identical "
          f"{rec['sweeps_identical']} (max diff {rec['sweep_max_diff']:.3e}),"
          f" two gradients identical {rec['grads_identical']} (max diff "
          f"{rec['grad_max_diff']:.3e})", flush=True)
    if not (rec["sweeps_identical"] and rec["grads_identical"]):
        raise AssertionError(f"{label}: the card is not bit-reproducible: "
                             f"{rec}")
    return rec


def steady_s(p, freqs, params=None) -> float:
    """One synchronised sweep's seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.solveForward(freqs, params)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dense_fault(dev) -> dict:
    """Phase 9 (c): the dense tier away from the build point."""
    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    freqs = np.linspace(40.0, 600.0, N_FREQ)
    truth = np.asarray(JOINT_TRUE)
    mat = pt.get_material(1550.0, "sol", angles=(45.0,), E1=truth[0],
                          E2=truth[1], G12=truth[2], nu12=truth[3],
                          beta=truth[4])
    p = sh_i_problem(dev, 1.0, mat=mat)
    out = {}
    for name, s in (("s", SOL45_S), ("s0", JOINT_S0)):
        th = truth * np.asarray(s)
        fr = p.solveForward(freqs, th).cpu().numpy()
        d = p.diagnoseSweep(freqs, th)
        idx = peak_points(fr)
        ref = splu_frf(p, freqs[idx], th)
        rel = np.abs(fr[idx] - ref) / np.abs(ref)
        rec = {"worst_rel_err": float(rel.max()),
               "f_peak": float(freqs[idx[1]]),
               "converged": int(d["converged"].sum()),
               "diag_fr_is_sweep": bool(np.array_equal(d["fr"], fr))}
        print(f"[slice6] (c) SOL 45 deg at {name} = {s} x truth, n="
              f"{p.n_free}, tier {p._tier}: rel err vs f64 splu at "
              + ", ".join(f"{freqs[i]:.3f} Hz {r:.3e}"
                          for i, r in zip(idx, rel))
              + f"; worst {rec['worst_rel_err']:.3e} (tol {ORACLE_TOL}); "
              f"diagnoseSweep: {rec['converged']} of {freqs.size} lanes "
              f"converged, its FRF is the sweep's: "
              f"{rec['diag_fr_is_sweep']}", flush=True)
        if not (rec["worst_rel_err"] <= ORACLE_TOL
                and rec["converged"] == freqs.size
                and rec["diag_fr_is_sweep"]):
            raise AssertionError(f"SOL 45 deg at {name}: {rec}")
        out[name] = rec
    return out


def tpu_benchmark(dev) -> dict:
    """Phase 9 (d): examples/tpu_benchmark.py's workflow through the port,
    held against the JAX package's CPU run of the same calls."""
    import torch

    from plate_inverse_problem_tpu_torch.io.compress import Compressor
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    tag = "[slice6] (d)"
    band_kernel.band_mv_f32_cuda.launches = 0
    csr_kernel.csr_mv_cuda.launches = 0
    t0 = time.perf_counter()
    p = sh_i_problem(dev, 1.0)
    p.getFRCore()
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    freq = np.linspace(40.0, 600.0, TPUB_N_FREQ)
    sweep_s = [steady_s(p, freq) for _ in range(2)]
    fr = p.solveForward(freq).cpu().numpy()
    checksum = float(np.abs(fr).sum())
    cs_rel = abs(checksum - TPUB_JAX_CHECKSUM) / TPUB_JAX_CHECKSUM
    n_comp = Compressor(freq, fr, TPUB_N_COMP, 1)(TPUB_N_COMP)[0].size
    print(f"{tag} sh_i refine=1 n={p.n_free} tier {p._tier}: construction "
          f"{ctor_s:.3f} s; {TPUB_N_FREQ}-point sweep first {sweep_s[0]:.3f} "
          f"s, steady {sweep_s[1]:.3f} s; checksum {checksum!r} vs the JAX "
          f"CPU run's {TPUB_JAX_CHECKSUM!r}: rel {cs_rel:.3e}; compressed to "
          f"{n_comp} frequencies", flush=True)
    failed = [] if cs_rel <= CHECKSUM_TOL else [f"checksum rel {cs_rel:.3e}"]

    runs = {}
    make = p.getLossFunction
    for name, (opt, steps, scaled) in TPUB_RUNS.items():
        stamps = []

        def timed_loss(*a, **k):
            loss = make(*a, **k)
            vg = loss.value_and_grad

            def value_and_grad(x):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                return vg(x)

            loss.value_and_grad = value_and_grad
            return loss

        p.getLossFunction = timed_loss
        try:
            res = p.solveInverse(
                list(TPUB_START), "MSE_LOG_AFC", opt, ref_fr=[freq, fr],
                use_rel=True, use_scaling=scaled,
                compression=(True, TPUB_N_COMP), log=False, report=False,
                N_steps=steps, h=0.001, f_min=1e-10)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        finally:
            del p.getLossFunction
        step_s = list(np.diff(stamps))
        for k, (f, s) in enumerate(zip(res.f_history, step_s)):
            print(f"{tag} {name} step {k}: loss {f:.10e}  {s:.4f} s",
                  flush=True)
        x_jax, niter_jax, status_jax = TPUB_JAX[name]
        rel = np.abs(np.asarray(res.x) - x_jax) / np.abs(x_jax)
        print(f"{tag} {name}: {opt} use_scaling={scaled}, {len(step_s)} "
              f"steps in {sum(step_s):.3f} s ({np.mean(step_s):.4f} s/step), "
              f"niter {res.niter}, status {res.status}; x "
              f"{np.asarray(res.x)!r}, rel to the JAX CPU run "
              f"{', '.join(f'{v:.3e}' for v in rel)} (tol {TPUB_TOL})",
              flush=True)
        if not (np.all(rel <= TPUB_TOL) and res.niter == niter_jax
                and res.status == status_jax):
            failed.append(f"{name}: rel {rel}, niter {res.niter}, "
                          f"status {res.status}")
        runs[name] = {"x": [float(v) for v in res.x],
                      "f_history": [float(f) for f in res.f_history],
                      "step_s": step_s, "rel_to_jax": [float(v) for v in rel]}
    k1 = band_kernel.band_mv_f32_cuda.launches
    k3 = csr_kernel.csr_mv_cuda.launches
    print(f"{tag} K3 launches {k3}, K1 {k1} over the workflow", flush=True)
    if k3 <= 0 or k1 != 0:
        failed.append(f"K3 {k3} (must be > 0), K1 {k1} (must be 0)")
    if failed:
        raise AssertionError(f"{tag} failed: " + "; ".join(failed))
    return {"ctor_s": ctor_s, "sweep_first_s": sweep_s[0],
            "sweep_steady_s": sweep_s[1], "checksum": checksum,
            "n_comp": int(n_comp), "runs": runs, "k3": k3}


def edp_plate(dev) -> dict:
    """Phase 9 (e): examples/edp_import.py's plate through the port."""
    import warnings

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    tag = "[slice6] (e)"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke", "plate_with_hole.edp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(EDP_SCRIPT)
    with warnings.catch_warnings():
        # the script's FE section is named and skipped; the sweep leaves
        # the basis band (f_max 600 Hz), as in the example
        warnings.simplefilter("ignore", RuntimeWarning)
        geom = pt.Geometry(path, height=2e-3)
        mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                              beta=0.003)
        p = pt.Problem(geom, mat, None, device=dev)
        freqs = np.linspace(60.0, 900.0, 121)
        sweep_s = [steady_s(p, freqs) for _ in range(2)]
        fr = p.solveForward(freqs).cpu().numpy()
    idx = [3, int(np.argmax(np.abs(fr))), 60, 120]
    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    rec = {"n_free": p.n_free, "nnz": int(p.op.pattern.nnz),
           "clamped_labels": list(geom.clamped_labels),
           "test_point": list(geom.test_point), "tier": list(p._tier),
           "sweep_first_s": sweep_s[0], "sweep_steady_s": sweep_s[1],
           "f_peak": float(freqs[idx[1]]), "worst_rel_err": float(rel.max())}
    print(f"{tag} plate with a hole from its .edp script: clamped labels "
          f"{geom.clamped_labels}, test point {geom.test_point}, n="
          f"{p.n_free} nnz={p.op.pattern.nnz}, tier {p._tier}, pure bending "
          f"{p.is_symmetric_path}; 121-point sweep first {sweep_s[0]:.3f} s,"
          f" steady {sweep_s[1]:.3f} s; rel err vs f64 splu at "
          + ", ".join(f"{freqs[i]:.1f} Hz {r:.3e}" for i, r in zip(idx, rel))
          + f"; worst {rec['worst_rel_err']:.3e} (tol {ORACLE_TOL})",
          flush=True)
    if not (rec["worst_rel_err"] <= ORACLE_TOL and p.is_symmetric_path
            and tuple(geom.clamped_labels) == (2,)
            and np.iscomplexobj(fr)):
        raise AssertionError(f"{tag} failed: {rec}")
    return rec


def slice6(dev, p21, freqs, fr21) -> dict:
    """Phase 9 on ``dev``; ``p21``/``fr21``: phase 6's 21k Problem and its
    FRF at the truth.  Returns the numbers for [summary] and K3's record
    for the kernels' line under "k3"."""
    from plate_inverse_problem_tpu_torch.ops import csr_kernel

    k3 = k3_cases(p21)
    bench = sh_i_problem(dev, 1.0)
    fr_bench = bench.solveForward(freqs).cpu().numpy()
    csr_kernel.csr_mv_cuda.launches = 0
    det = {"bench_1466": determinism(bench, freqs, fr_bench, "n=1466"),
           "k3_1466": csr_kernel.csr_mv_cuda.launches}
    del bench
    csr_kernel.csr_mv_cuda.launches = 0
    det["sh_i_21k"] = determinism(p21, freqs, fr21, f"n={p21.n_free}")
    det["k3_21k"] = csr_kernel.csr_mv_cuda.launches
    out = {"k3_cases": k3["cases"], "determinism": det,
           "dense_fault": dense_fault(dev), "tpu_benchmark": tpu_benchmark(dev),
           "edp": edp_plate(dev)}
    out["k3"] = {"headline": k3["headline"],
                 "launches": out["tpu_benchmark"]["k3"],
                 "by_path": {"tpu_benchmark_1466": out["tpu_benchmark"]["k3"],
                             "determinism_1466": det["k3_1466"],
                             "determinism_21k": det["k3_21k"]}}
    return out


if __name__ == "__main__":
    sys.exit(main())
