"""The north-star run on the port (counterpart of ``.probes/
ortho_northstar.py``, which drives the JAX package): the orthotropic joint
inverse, E1, E2, G12, nu12 and beta recovered by Gauss-Newton from three
SOL cuts at 0 / 90 / 45 degrees sharing one theta, each cut a 512-point
sweep at the truth (120e9, 8.5e9, 4.5e9, 0.30, 0.006) compressed to 128
points (``io.compress`` alg 1), 12 steps from the JAX record's s0 (its
``rng(0)`` draw at PERT 0.35, ``.probes/northstar_results.jsonl``).
Imports no jax; runs on the card (``--device cpu`` for a small plate).

Reported separately, each synchronised: construction (3 Problems),
synthetic data (3 sweeps and the compression), the first joint r + J
and a steady one, the inverse (N Gauss-Newton steps, each step's
seconds), loss first and final, each parameter's relative error (beta
also up to its sign: |FRF| is even in beta) and the peak device memory.
Prints the card's name and power limit and a ``RECORD`` JSON line, and
appends the record to ``build/northstar/northstar_torch.jsonl``.

Run from the repository root:
    python3 .probes/northstar_torch.py --refine 4
    python3 .probes/northstar_torch.py --refine 9
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

TRUE = np.array([120e9, 8.5e9, 4.5e9, 0.30, 0.006])
ANGLES = (0.0, 90.0, 45.0)
S0 = (1.0959, 0.8389, 0.6787, 0.6616, 1.2193)


def main() -> int:
    import torch

    import plate_inverse_problem_tpu_torch as pt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refine", type=float, default=4.0)
    ap.add_argument("--nfreq", type=int, default=512)
    ap.add_argument("--comp", type=int, default=128)
    ap.add_argument("--nsteps", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("northstar_torch: no CUDA device.")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rec = {"refine": args.refine, "freqs": args.nfreq, "comp": args.comp,
           "nsteps": args.nsteps, "angles": list(ANGLES), "s0": list(S0),
           "device": str(dev)}
    if cuda:
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(rec["card"], flush=True)
        torch.cuda.reset_peak_memory_stats()

    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=args.refine)
    t0 = time.perf_counter()
    problems = []
    for a in ANGLES:
        mat = pt.get_material(1550.0, "sol", angles=(a,), E1=TRUE[0],
                              E2=TRUE[1], G12=TRUE[2], nu12=TRUE[3],
                              beta=TRUE[4])
        p = pt.Problem(geom, mat, acc, device=dev)
        p.getFRCore()
        problems.append(p)
    sync()
    rec["ctor_s"] = time.perf_counter() - t0
    rec["n_free"] = int(problems[0].n_free)
    rec["tier"] = list(problems[0]._tier)
    rec["coarse_inv_s"] = [getattr(p, "_coarse_inv_s", None)
                           for p in problems]
    print(f"3 cuts built: n_free={rec['n_free']} tier {rec['tier']} "
          f"construction {rec['ctor_s']:.1f} s (the coarse inverses "
          f"{rec['coarse_inv_s']} s)", flush=True)

    freqs = np.linspace(40.0, 600.0, args.nfreq)
    t0 = time.perf_counter()
    datasets, cut_s = [], []
    for p in problems:
        tc = time.perf_counter()
        fr = p.solveForward(freqs, TRUE).cpu().numpy()
        sync()
        cut_s.append(time.perf_counter() - tc)
        datasets.append(pt.Compressor(freqs, fr.astype(complex),
                                      args.nfreq, 1)(args.comp))
    rec["synth_s"] = time.perf_counter() - t0
    rec["cut_sweep_s"] = cut_s
    print(f"synthetic sweeps + compression to {args.comp} points: "
          f"{rec['synth_s']:.1f} s (sweeps {[round(s, 3) for s in cut_s]})",
          flush=True)

    joint = pt.JointResidual([
        p.getResidualFunction(cf, cfr, kind="log_afc", scaling_params=TRUE)
        for p, (cf, cfr) in zip(problems, datasets)])
    s0 = np.asarray(S0)
    for key in ("gn_first_s", "gn_steady_s"):
        t0 = time.perf_counter()
        joint.value_and_jac(s0)
        sync()
        rec[key] = time.perf_counter() - t0
    print(f"joint r + J: first {rec['gn_first_s']:.3f} s, steady "
          f"{rec['gn_steady_s']:.3f} s", flush=True)

    stamps = []
    value_and_jac = joint.value_and_jac

    def timed(x):
        sync()
        stamps.append(time.perf_counter())
        return value_and_jac(x)

    joint.value_and_jac = timed
    t0 = time.perf_counter()
    res = pt.optimize_gauss_newton(joint, s0, N_steps=args.nsteps,
                                   f_min=1e-16)
    sync()
    rec["inverse_s"] = time.perf_counter() - t0
    stamps.append(time.perf_counter())
    rec["gn_iter_s"] = list(np.diff(stamps))
    rec["gn_s_per_iter"] = rec["inverse_s"] / len(res.f_history)
    x = np.asarray(res.x) * TRUE
    rel_raw = np.abs(x - TRUE) / TRUE
    x[4] = abs(x[4])
    rel = np.abs(x - TRUE) / TRUE
    rec |= {"status": str(res.status), "iterations": len(res.f_history),
            "loss_history": [float(f) for f in res.f_history],
            "loss_first": float(res.f_history[0]), "loss_final": float(res.f),
            "param_rel_err": [float(e) for e in rel],
            "param_rel_err_raw": [float(e) for e in rel_raw]}
    if cuda:
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for k, (f, s) in enumerate(zip(res.f_history, rec["gn_iter_s"])):
        print(f"[gn] iterate {k}: loss {f:.6e}  {s:.3f} s", flush=True)
    print(f"{len(res.f_history)}-step joint GN inverse: "
          f"{rec['inverse_s']:.1f} s ({rec['gn_s_per_iter']:.3f} s/iter, "
          f"status {res.status}, loss {rec['loss_first']:.3e} -> "
          f"{rec['loss_final']:.3e}); peak device memory "
          f"{rec.get('peak_mem_gb', float('nan')):.2f} GB", flush=True)
    print("param rel err (|beta|):", ", ".join(f"{e:.3e}" for e in rel),
          "; raw:", ", ".join(f"{e:.3e}" for e in rel_raw), flush=True)
    out = os.path.join(ROOT, "build", "northstar")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "northstar_torch.jsonl"), "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    print("RECORD", json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
