"""Where the time goes in the PyTorch port's 21k-DOF band-tier sweep (one GPU).

Builds the slice that chip_smoke.py drives (sh_i strip, refine = 4,
isotropic steel, AP1030, 512 frequencies over 40-600 Hz) on ``cuda`` and:

1. runs a first sweep, then three timed steady sweeps (wall seconds,
   synchronised);
2. runs one more steady sweep under ``torch.profiler`` with counting
   wrappers around the sweep's layers: FGMRES chunks and cycles, two-grid
   cycles (preconditioner applies = cycles / 2), f64 band applies, K1
   launches; and reports the device time (sum of the CUDA kernels' self
   time), the device time by kernel kind, the idle share of the mean
   steady sweep, and the count and host time of ``cudaLaunchKernel``;
3. builds two more Problems (two more ARPACK start vectors, so two more
   band bases) and, for all three, the worst relative FRF error against
   the host f64 splu oracle at 4 points including the |FRF| peak.

Prints the JSON record as its last line and writes it, with the
profiler's kernel table, under ``--out`` (default build/profile/).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 .probes/torch_sweep_profile.py
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_FREQ = 512
KINDS = [("K1 band_mv_f32", ("band_mv_f32_kernel",)),
         ("gemm", ("gemm", "gemv", "cutlass", "dot_kernel")),
         ("index_add/scatter/gather", ("index", "scatter", "gather")),
         ("cat/stack", ("cat", "Cat")),
         ("reduce", ("reduce", "Reduce")),
         ("elementwise", ("elementwise", "Elementwise", "vectorized"))]


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def build(dev):
    import plate_inverse_problem_tpu_torch as pt

    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=4.0)
    p = pt.Problem(geom, mat, acc, device=dev)
    p.getFRCore()
    return p


def worst_oracle_err(p, freqs, fr):
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    ipk = int(np.argmax(fr))
    idx = [3, ipk, freqs.size // 2, freqs.size - 1]
    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    return float(rel.max()), float(freqs[idx[int(np.argmax(rel))]])


def count_calls(module, name, counts):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from plate_inverse_problem_tpu_torch.ops import band_kernel, mixed

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    band_kernel.build()
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    p = build(dev)
    torch.cuda.synchronize()
    rec["ctor_s"] = time.perf_counter() - t0
    freqs = np.linspace(40.0, 600.0, N_FREQ)

    def sweep():
        y = p.solveForward(freqs)
        torch.cuda.synchronize()
        return y

    t0 = time.perf_counter()
    fr = sweep().cpu().numpy()
    rec["sweep_first_s"] = time.perf_counter() - t0
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep()
        steady.append(time.perf_counter() - t0)
    rec["sweep_steady_s"] = steady
    mean_steady = float(np.mean(steady))
    print(f"[sweep] first {rec['sweep_first_s']:.3f} s, steady "
          f"{', '.join(f'{s:.3f}' for s in steady)} s", flush=True)

    # ---- one profiled steady sweep with counting wrappers -----------------
    counts = {}
    undo = [count_calls(mixed, nm, counts) for nm in
            ("_pgmres", "_pgmres_cycle", "twogrid_apply", "band_mv")]
    band_kernel.band_mv_f32_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep()
    for u in undo:
        u()
    rec["counts"] = {
        "chunks": counts.get("_pgmres", 0),
        "fgmres_cycles": counts.get("_pgmres_cycle", 0),
        "twogrid_cycles": counts.get("twogrid_apply", 0),
        "precond_applies": counts.get("twogrid_apply", 0)
        // (1 + mixed._MG_REFINE),
        "f64_band_applies": counts.get("band_mv", 0),
        "k1_launches": band_kernel.band_mv_f32_cuda.launches,
    }

    events = prof.key_averages()
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")

    def dev_us(e):
        return getattr(e, sort_key)

    kernels, by_kind, launch = [], {}, {"count": 0, "host_ms": 0.0}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            kernels.append((dev_us(e) / 1e3, e.count, e.key))
            k = kind_of(e.key)
            by_kind[k] = by_kind.get(k, 0.0) + dev_us(e) / 1e3
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launch["count"] += e.count
            launch["host_ms"] += e.cpu_time_total / 1e3
    busy_ms = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    rec["device_busy_ms"] = busy_ms
    rec["idle_share_of_mean_steady"] = 1.0 - busy_ms / (mean_steady * 1e3)
    rec["device_ms_by_kind"] = dict(sorted(by_kind.items(),
                                           key=lambda kv: -kv[1]))
    rec["kernel_launches"] = launch
    rec["top_kernels"] = [{"ms": ms, "count": c, "name": nm[:120]}
                          for ms, c, nm in kernels[:12]]
    print(f"[profile] device busy {busy_ms:.1f} ms of a {mean_steady * 1e3:.1f}"
          f" ms mean steady sweep; {launch['count']} kernel launches "
          f"({launch['host_ms']:.1f} ms host); counts {rec['counts']}",
          flush=True)
    for kind, ms in rec["device_ms_by_kind"].items():
        print(f"[profile]   {kind:26s} {ms:9.3f} ms "
              f"({100 * ms / busy_ms:.1f} %)", flush=True)

    # ---- accuracy over three band bases -----------------------------------
    errs = [worst_oracle_err(p, freqs, fr)]
    for _ in range(2):
        q = build(dev)
        errs.append(worst_oracle_err(q, freqs, q.solveForward(freqs)
                                     .cpu().numpy()))
        del q
    rec["worst_rel_err_by_basis"] = [e for e, _ in errs]
    rec["worst_at_hz"] = [f for _, f in errs]
    print(f"[oracle] worst rel err vs f64 splu per basis: "
          f"{', '.join(f'{e:.3e} at {f:.3f} Hz' for e, f in errs)}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_sweep_profile.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    with open(os.path.join(args.out, "torch_sweep_profile.txt"), "w") as fh:
        fh.write(events.table(sort_by=sort_key, row_limit=60))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
