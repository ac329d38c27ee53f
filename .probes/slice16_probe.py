"""K3's long-row kernel on one card, without the rest of ``chip_smoke.py``:
builds ``csrc/csr_mv.cu`` (printing ``-Xptxas -v``'s lines of the long-row
and one-lane kernels) and, with ``--ab-csr SOURCE``, another version of K3
beside it; prints the card's name and power limit; runs phase 13 (a)
(``chip_smoke.long_rows``: the four cases against the plain version, two
launches bit for bit, the tiles' and the long rows' launches timed alone,
the A/B kernel's, ``torch.sparse.mm`` and the bound, then the sparse API's
``matvec``), and with ``--wide`` phase 14 (g) alone (``chip_smoke.
dof_wide``: the bench two-grid on 8 gloo ranks of the card).  Writes the
record to ``build/slice16/slice16.json``; exits 1 if a check fails.

The parent's kernel for the A/B:
    git show HEAD:plate_inverse_problem_tpu_torch/csrc/csr_mv.cu \\
        > build/csr_mv_pr15.cu

Run from the repository root:
    python3 .probes/slice16_probe.py [--ab-csr build/csr_mv_pr15.cu] [--wide]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab-csr", action="append", default=[])
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="only the device time of each kernel of phase 13 "
                         "(a)'s four cases, by torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slice16_probe: no CUDA device.")
    dev = torch.device("cuda")
    card = cs.card_info()
    print(card, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 + len(args.ab_csr)) as pool:
        builds = [pool.submit(band_kernel.build),
                  pool.submit(csr_kernel.build)]
        ab = [pool.submit(cs.load_ab_csr, s) for s in args.ab_csr]
        report = [f.result() for f in builds][1]
        ab = [f.result() for f in ab]
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    for line in cs.ptxas_summary(report):
        if "long" in line or "l1" in line:
            print(f"[build] csr_mv.cu: {line}", flush=True)
    out = {"card": card}
    if args.profile:
        out["profile"] = profile_cases(cs, dev)
        os.makedirs(os.path.join("build", "slice16"), exist_ok=True)
        with open(os.path.join("build", "slice16", "profile.json"), "w") as f:
            json.dump(out, f)
        return 0
    failed = []
    try:
        out["long_rows"] = cs.long_rows(dev, ab)
    except AssertionError as err:
        failed.append(str(err))
    if args.wide:
        out["wide"] = cs.dof_wide(dev, os.path.join("build", "slice16",
                                                    "g"), failed)
    os.makedirs(os.path.join("build", "slice16"), exist_ok=True)
    with open(os.path.join("build", "slice16", "slice16.json"), "w") as f:
        json.dump(out, f, default=str)
    if failed:
        print("FAILED: " + " | ".join(failed), flush=True)
        return 1
    print("[slice16] ok", flush=True)
    return 0


def profile_cases(cs, dev, reps: int = 10) -> dict:
    """Each phase 13 (a) case's K3 call, ``reps`` times under
    torch.profiler: the mean device microseconds of each kernel a call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    csr = cs.long_row_pattern(dev)
    out = {}
    for S, L, name, _ in cs.LONG_CASES:
        dt = torch.float64 if name == "f64" else torch.float32
        rng = np.random.default_rng(0)
        data = torch.as_tensor(rng.standard_normal((S, csr.nnz)), dtype=dt,
                               device=dev)
        x = torch.as_tensor(rng.standard_normal((L, csr.n)), dtype=dt,
                            device=dev)
        for _ in range(3):
            ck.csr_mv_cuda(data, x, csr)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.csr_mv_cuda(data, x, csr)
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0:
                rows[ev.key[:60]] = t / reps
        key = f"S={S} L={L} {str(dt)[6:]}"
        out[key] = rows
        print(f"[profile] {key}: " + "; ".join(
            f"{k} {v:.1f} us" for k, v in sorted(rows.items(),
                                                  key=lambda kv: -kv[1])),
              flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
