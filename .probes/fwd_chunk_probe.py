"""What the forward-mode r + J's frequency chunk costs and holds at 21k
(sh_i refine = 4, n = 20916, band + two-grid tier, 512 points over 40-600
Hz): isotropic steel (p = 3) and OrthotropicD4 (p = 8, scaled variables),
``ResidualFunction(kind="log_afc", jac_mode="fwd")`` built directly with
freq_chunk in (32, 64, 128, 256, None), each timed (synchronised, after a
warm-up call) with the peak device memory above what was allocated before
the call.  The peak's growth with the chunk is the state held across the
sweep, which the sweep's own lane chunk does not bound: its slope per lane
(one lane = one frequency's primal or one tangent) in f64 n-vectors is
printed for each plate.

Run on a machine with an NVIDIA GPU from the repository root:
    python3 .probes/fwd_chunk_probe.py
Prints one JSON line per call and a summary line per plate, and writes them
to build/profile/fwd_chunk.jsonl.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNKS = (32, 64, 128, 256, None)
D4 = dict(E1=210e9, E2=200e9, G12=75e9, nu12=0.33, b1=0.003, b2=0.003,
          b3=0.004, b4=0.0)
D4_START = (1.02, 0.98, 1.03, 0.97, 1.1, 0.9, 1.05, 1.0)


def plate(pt, mat):
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=4.0)
    return pt.Problem(geom, mat, acc, device="cuda")


def measure(torch, pt, label, p, freqs, x0, scale, out):
    core, od = p.getFRCore()
    fr = p.solveForward(freqs).cpu().numpy()

    def call(chunk):
        rf = pt.ResidualFunction(core, od, freqs, fr, kind="log_afc",
                                 scaling_params=scale, freq_chunk=chunk,
                                 jac_mode="fwd")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r, J = rf.value_and_jac(x0)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return s, (torch.cuda.max_memory_allocated() - base) / 1e9, \
            J.cpu().numpy()

    call(64)                                    # warm-up
    lanes = 1 + x0.size
    rows = []
    J_ref = None
    for chunk in CHUNKS:
        s, peak, J = call(chunk)
        c = freqs.size if chunk is None else chunk
        if chunk is None:
            J_ref = J
        rec = {"plate": label, "n_free": p.n_free, "p": int(x0.size),
               "freq_chunk": chunk, "lanes_per_block": c * lanes, "s": s,
               "peak_gb": peak, "sweep_chunk": p._auto_freq_chunk(),
               "n_refine": p.n_refine}
        rows.append(rec)
        print(json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")
    lb = np.array([r["lanes_per_block"] for r in rows], float)
    pk = np.array([r["peak_gb"] for r in rows]) * 1e9
    slope, icpt = np.polyfit(lb, pk, 1)
    summ = {"plate": label, "bytes_per_lane": slope,
            "f64_vectors_per_lane": slope / (8.0 * p.n_free),
            "intercept_gb": icpt / 1e9,
            "unchunked_s": rows[-1]["s"], "unchunked_peak_gb": rows[-1][
                "peak_gb"], "J_ref_max": float(np.abs(J_ref).max())}
    print(json.dumps(summ), flush=True)
    out.write(json.dumps(summ) + "\n")


def main() -> int:
    import torch

    import plate_inverse_problem_tpu_torch as pt

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    free, total = torch.cuda.mem_get_info()
    print(f"device memory: {total / 1e9:.2f} GB total, {free / 1e9:.2f} GB "
          "free", flush=True)
    freqs = np.linspace(40.0, 600.0, 512)
    os.makedirs("build/profile", exist_ok=True)
    with open("build/profile/fwd_chunk.jsonl", "w") as out:
        out.write(json.dumps({"card": card, "total_gb": total / 1e9}) + "\n")
        iso = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                              beta=0.003)
        p = plate(pt, iso)
        truth = np.asarray(p.parameters, np.float64)
        measure(torch, pt, "isotropic", p, freqs,
                truth * np.array([1.05, 1.02, 1.2]), None, out)
        del p
        torch.cuda.empty_cache()
        p = plate(pt, pt.get_material(7920.0, "orthotropic_d4", **D4))
        truth = np.asarray(p.parameters, np.float64)
        scale = np.where(truth != 0.0, truth, 1e-3)
        measure(torch, pt, "orthotropic_d4", p, freqs,
                truth * np.asarray(D4_START) / scale, scale, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
