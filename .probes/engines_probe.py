"""Phase 11 of ``chip_smoke.py`` (the modal and direct engines) alone on
one NVIDIA GPU: builds the two kernels as phase 2 does, prints the card's
name and power limit, runs ``chip_smoke.engines`` and writes its record
to ``build/engines/engines.json``.  Exits 1 if a check of the phase
fails.

Run from the repository root:  python3 .probes/engines_probe.py
"""
from __future__ import annotations

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

    if not torch.cuda.is_available():
        raise SystemExit("engines_probe: no CUDA device.")
    print(cs.card_info(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(band_kernel.build), pool.submit(csr_kernel.build)]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    rc = 0
    try:
        rec = cs.engines(torch.device("cuda"))
    except AssertionError as err:
        print(f"FAILED: {err}", flush=True)
        rec, rc = {"failed": str(err)}, 1
    print(f"[time] phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.join(ROOT, "build", "engines")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "engines.json"), "w") as f:
        json.dump(rec, f, default=float)
    return rc


if __name__ == "__main__":
    sys.exit(main())
