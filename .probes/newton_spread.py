"""Reproducibility and spread of ``chip_smoke.py`` phase 10 (c)'s damped
Newton run on one NVIDIA GPU: the bench plate (n = 1466) built afresh,
its FRF at the truth, then ``solveInverse(theta_0, "MSE_LOG_AFC",
"newton", use_scaling=True, N_steps=30)`` from truth x (1.05, 1.02, 1.2)
exactly as phase 10 (c) calls it, through the mixed engine.

* ``--runs`` fresh Problems with the band basis's fixed ARPACK start
  (``ops/mixed.py``'s ``_BASIS_SEED``): their bases, FRFs and Newton
  iterates must be the same bits (exit 1 otherwise);
* one run for each seed of ``--seeds`` (a different start vector, so a
  basis that differs by ARPACK's tolerance): how the path depends on it.

Prints each run's iterations, status, distance to the truth and its loss
and iterate history.

Run from the repository root:
  python3 .probes/newton_spread.py [--runs 2] [--seeds 1 2 3]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def newton_run(cs, dev, freqs, label):
    p = cs.sh_i_problem(dev, 1.0)
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(cs.START)
    fr = p.solveForward(freqs).cpu().numpy()
    W = p.getFRCore()[1]["W64"].cpu().numpy()
    t0 = time.perf_counter()
    res = p.solveInverse(th0, "MSE_LOG_AFC", "newton", ref_fr=(freqs, fr),
                         use_scaling=True, report=False, log=False,
                         N_steps=cs.SO_STEPS["newton"])
    s = time.perf_counter() - t0
    err = (np.abs(res.x) - truth) / truth
    xs = np.array([np.asarray(x) * th0 / truth for x in res.x_history])
    print(f"[newton] {label}: checksum {np.abs(fr).sum()!r}; "
          f"{len(res.f_history)} iterations in {s:.2f} s, status "
          f"{res.status}; rel err {', '.join(f'{e:+.3e}' for e in err)}",
          flush=True)
    print(f"[newton]   f: {', '.join(f'{f:.3e}' for f in res.f_history)}",
          flush=True)
    print("[newton]   x/truth: " + "; ".join(
        ",".join(f"{v:.4f}" for v in x) for x in xs), flush=True)
    return W, fr, xs, np.asarray(res.f_history)


def main() -> int:
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import csr_kernel, mixed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("newton_spread: no CUDA device.")
    print(cs.card_info(), flush=True)
    csr_kernel.build()
    dev = torch.device("cuda")
    freqs = np.linspace(40.0, 600.0, cs.N_FREQ)
    runs = [newton_run(cs, dev, freqs, f"seed {mixed._BASIS_SEED} run {r}")
            for r in range(args.runs)]
    same = all(all(np.array_equal(a, b) for a, b in zip(runs[0], r))
               for r in runs[1:])
    print(f"[newton] {args.runs} fresh Problems, seed {mixed._BASIS_SEED}: "
          f"bases, FRFs, iterates and losses identical {same}", flush=True)
    seed0 = mixed._BASIS_SEED
    try:
        for seed in args.seeds:
            mixed._BASIS_SEED = seed
            newton_run(cs, dev, freqs, f"seed {seed}")
    finally:
        mixed._BASIS_SEED = seed0
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
