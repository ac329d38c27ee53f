"""Where the dense tier's sweep time goes with K3 (``csrc/csr_mv.cu``) as
its flat-pattern operator, on an NVIDIA GPU.

For the bench plate (``sh_i`` refine = 1, n = 1466: flat + dense) and the
largest dense-tier plate (refine = 3, n = 11910: band + dense), isotropic
steel, AP1030, 512 points over 40-600 Hz: a first and three steady
synchronised sweeps, then one steady sweep under ``torch.profiler``:
device busy time (the CUDA kernels' self time), the idle share of the mean
steady sweep, device time by kernel kind (K3 on its own line), the kernel
launches, and K3's launches in the sweep (by regime).  Prints one line per
plate and kind, then one JSON line; the profiler's kernel table goes to
``--out`` (default build/profile/).

Run from the repository root:

    python3 .probes/k3_profile.py
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
KINDS = [("K3 csr_mv", ("csr_mv_",)),
         ("gemm", ("gemm", "gemv", "cutlass", "dot_kernel")),
         ("index/scatter/gather", ("index", "scatter", "gather")),
         ("transpose/copy", ("copy", "Copy", "transpose")),
         ("cat/stack", ("cat", "Cat")),
         ("reduce", ("reduce", "Reduce")),
         ("elementwise", ("elementwise", "Elementwise", "vectorized"))]


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profile_events(prof, wall_ms: float) -> dict:
    """Device busy (sum of the CUDA kernels' self time), the idle share of
    ``wall_ms``, device ms by kernel kind and the launch count."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    by_kind, busy, launches = {}, 0.0, 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms = getattr(e, key) / 1e3
            busy += ms
            by_kind[kind_of(e.key)] = by_kind.get(kind_of(e.key), 0.0) + ms
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launches += e.count
    return {"device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "kernel_launches": launches,
            "_table": events.table(sort_by=key, row_limit=40)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import csr_kernel

    if not torch.cuda.is_available():
        raise SystemExit("k3_profile: no CUDA device; nothing was run.")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    csr_kernel.build()
    dev = torch.device("cuda")
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    rec, tables = {"card": card, "torch": torch.__version__}, []
    for refine in (1.0, 3.0):
        p = cs.sh_i_problem(dev, refine)
        p.getFRCore()
        first = cs.steady_s(p, freqs)
        steady = [cs.steady_s(p, freqs) for _ in range(3)]
        csr_kernel.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cs.steady_s(p, freqs)
        ev = profile_events(prof, 1e3 * float(np.mean(steady)))
        tables.append(ev.pop("_table"))
        r = {"n_free": p.n_free, "tier": list(p._tier), "sweep_first_s": first,
             "sweep_steady_s": steady,
             "k3_launches": csr_kernel.csr_mv_cuda.launches,
             "k3_by_regime": dict(csr_kernel.csr_mv_cuda.launches_by_regime),
             **ev}
        print(f"[k3_profile] n={p.n_free} tier {p._tier}: sweep first "
              f"{first:.4f} s, steady {', '.join(f'{t:.4f}' for t in steady)}"
              f" s; device busy {ev['device_busy_ms']:.2f} ms of "
              f"{ev['wall_ms']:.2f} ms (idle {100 * ev['idle_share']:.1f} %),"
              f" {ev['kernel_launches']} launches, K3 {r['k3_launches']} "
              f"{r['k3_by_regime']}",
              flush=True)
        for kind, ms in ev["device_ms_by_kind"].items():
            print(f"[k3_profile]   {kind:22s} {ms:9.3f} ms "
                  f"({100 * ms / ev['device_busy_ms']:.1f} %)", flush=True)
        rec[f"n{p.n_free}"] = r
        del p
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "k3_profile.txt"), "w") as fh:
        fh.write("\n\n".join(tables))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
