"""Phase 12 of ``chip_smoke.py`` (the LOBPCG band basis, the flat
multilevel preconditioner, the sparse API, K3 on rectangular patterns)
alone on one NVIDIA GPU: builds the two kernels as phase 2 does, prints the
card's name and power limit, builds the ARPACK Problems phase 12 compares
with (``sh_i`` refine 1, 3 and 4: n = 1466, 11910, 20916), runs
``chip_smoke.slice10`` and writes its record to
``build/slice10/slice10.json``.  Exits 1 if a check of the phase fails.

Run from the repository root:  python3 .probes/slice10_probe.py
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
        raise SystemExit("slice10_probe: no CUDA device.")
    dev = torch.device("cuda")
    print(cs.card_info(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(band_kernel.build),
                  pool.submit(csr_kernel.build)]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    arpack = {}
    for refine in (1.0, 3.0):
        p, _ = cs.construct(dev, refine, f"ARPACK sh_i refine={refine}",
                            tag="[arpack]")
        arpack[p.n_free] = {"lam": p._band_lam, "basis_s": p._band_basis_s}
        del p
    p21, _ = cs.construct(dev, 4.0, "ARPACK sh_i refine=4", tag="[arpack]")
    t0 = time.perf_counter()
    rc = 0
    try:
        rec = cs.slice10(dev, p21, arpack)
    except AssertionError as err:
        print(f"FAILED: {err}", flush=True)
        rec, rc = {"failed": str(err)}, 1
    print(f"[time] phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.join(ROOT, "build", "slice10")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "slice10.json"), "w") as f:
        json.dump(rec, f, default=float)
    return rc


if __name__ == "__main__":
    sys.exit(main())
