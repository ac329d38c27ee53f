"""The bench plate's (sh_i refine = 1, n = 1466, 512 points over 40-600 Hz)
second-order checks on the card, in more detail than chip_smoke.py's
phase 10 (c):

* the MSE_LOG_AFC Hessian at theta_0 = truth x (1.05, 1.02, 1.2), in x =
  theta / theta_0, against central differences of the port's gradient at
  several steps and their Richardson extrapolation (truncation vs noise);
* Gauss-Newton on MSE (the 'complex' residual) from theta_0, every
  iterate's loss and distance to the truth, for ``--gn-steps`` steps, and
  from ``--gn-start`` (theta / truth), if given;
* ``--first-call``: instead, in this fresh process, the 21k plate's
  (refine = 4) forward-mode r + J before any other derivative, first and
  steady, then the adjoint r + J, first and steady: what a process pays
  for its first forward-mode and first adjoint Jacobian.

Run on a machine with an NVIDIA GPU from the repository root:
    python3 .probes/second_order_probe.py [--gn-steps 60]
        [--gn-start 1.01 1.005 1.05] [--first-call]
Prints one line per measurement; nothing is written.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import plate_inverse_problem_tpu_torch as pt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gn-steps", type=int, default=60)
    ap.add_argument("--gn-start", type=float, nargs=3, default=None)
    ap.add_argument("--first-call", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=1.0)
    freqs = np.linspace(40.0, 600.0, 512)
    if args.first_call:
        return first_call(pt, acc, mat, freqs)
    p = pt.Problem(geom, mat, acc, device="cuda")
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.array([1.05, 1.02, 1.2])
    fr = p.solveForward(freqs).cpu().numpy()

    loss = p.getLossFunction(freqs, fr, "MSE_LOG_AFC", scaling_params=th0)
    x1 = np.ones(3)
    _, g, H = (a.cpu().numpy() for a in loss.value_grad_hessian(x1))
    print(f"[hess] |g| max {np.abs(g).max():.3e}; column max |H| "
          f"{', '.join(f'{v:.3e}' for v in np.abs(H).max(0))}", flush=True)

    def diff(j, h):
        e = np.zeros(3)
        e[j] = h
        return (loss.grad(x1 + e).cpu().numpy()
                - loss.grad(x1 - e).cpu().numpy()) / (2.0 * h)

    for h in (1e-3, 3e-4, 1e-4, 3e-5, 1e-5):
        D = np.stack([diff(j, h) for j in range(3)], axis=1)
        D2 = np.stack([diff(j, h / 2) for j in range(3)], axis=1)
        R = (4.0 * D2 - D) / 3.0
        dev = np.abs(D - H).max(0) / np.abs(H).max(0)
        rdev = np.abs(R - H).max(0) / np.abs(H).max(0)
        print(f"[hess] step {h:.0e}: central differences "
              f"{', '.join(f'{v:.3e}' for v in dev)}; Richardson (h, h/2) "
              f"{', '.join(f'{v:.3e}' for v in rdev)} of the column max",
              flush=True)

    starts = [th0] + ([] if args.gn_start is None
                      else [truth * np.asarray(args.gn_start)])
    for start in starts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = p.solveInverse(start, "MSE", "gn", ref_fr=(freqs, fr),
                             use_scaling=True, report=False, log=False,
                             N_steps=args.gn_steps)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        tag = f"[gn-mse from {', '.join(f'{v:.4g}' for v in start / truth)}]"
        for k, (f, x) in enumerate(zip(res.f_history, res.x_history)):
            err = (np.abs(np.asarray(x) * start) - truth) / truth
            print(f"{tag} iterate {k}: loss {f:.6e} rel err "
                  f"{', '.join(f'{v:+.3e}' for v in err)}", flush=True)
        err = (np.abs(res.x) - truth) / truth
        print(f"{tag} {len(res.f_history)} iterations in {s:.3f} s, status "
              f"{res.status}; result rel err "
              f"{', '.join(f'{v:+.3e}' for v in err)}", flush=True)
    return 0


def first_call(pt, acc, mat, freqs) -> int:
    """The 21k plate's first and steady forward-mode r + J in a fresh
    process, then its first and steady adjoint r + J."""
    import torch

    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=4.0)
    p = pt.Problem(geom, mat, acc, device="cuda")
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.array([1.05, 1.02, 1.2])
    fr = p.solveForward(freqs).cpu().numpy()
    for mode in ("fwd", "adjoint"):
        rf = p.getResidualFunction(freqs, fr, jac_mode=mode)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rf.value_and_jac(th0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[first-call] n={p.n_free} {mode} r + J (freq_chunk "
              f"{rf._chunk}): first {times[0]:.3f} s, steady "
              f"{times[1]:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
