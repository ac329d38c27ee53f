"""Phase 14 of ``chip_smoke.py`` (frequency sharding over
torch.distributed) alone: builds the two kernels as phase 2 does, prints
the card's name and power limit and the card count, runs
``chip_smoke.slice12`` and writes its record to
``build/slice12/slice12.json``.  Exits 1 if a check of the phase fails.

``--parts`` picks the parts (default "abcd"; (a) always runs); with four
cards, ``--parts ad`` runs (a) at world 4 over NCCL and the workflow on a
(freq 2, dof 2) mesh.

Run from the repository root:  python3 .probes/slice12_probe.py [--parts ad]
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
    ap.add_argument("--parts", default="abcd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slice12_probe: no CUDA device.")
    dev = torch.device("cuda")
    print(cs.card_info(), flush=True)
    print(f"[slice12] {torch.cuda.device_count()} card(s): "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(band_kernel.build),
                  pool.submit(csr_kernel.build)]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    out = cs.slice12(dev, args.parts)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[time] phase 14 in {out['phase_s']:.1f} s", flush=True)
    os.makedirs(os.path.join(ROOT, "build", "slice12"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "slice12", "slice12.json"),
              "w") as fh:
        json.dump(out, fh, default=float, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
