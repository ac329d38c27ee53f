"""What the rescue cycles of the mixed sweep (``ops/mixed._pgmres``,
``n_rescue``) and the f64 Krylov basis buy and cost, on an NVIDIA GPU.

For each plate, at 512 points over 40-600 Hz, every variant of the solve:
the Krylov basis the tier picks ("auto") and, on a dense tier, the other
one (``basis_f32`` flipped, on the same operator data and band basis),
each with the rescue cycles off (``n_rescue=0``, the JAX package's
stopping point) and on.  Per variant:
the lanes ``diagnoseSweep`` flags unconverged, their exit residual and
their residual after the final band corrections over the target, the
FGMRES cycles a sweep runs, the relative error against the refined f64
splu oracle at the flagged lanes and the peak points, and the steady sweep
(variants in turns, forwards then backwards).  Plates: the bench plate
(``sh_i`` refine = 1, isotropic steel, n = 1466), the SOL 45 deg cut
built at the truth and solved at s and s0 x truth (n = 1466), refine = 3
(n = 11910, band + dense), refine = 4 (n = 20916, band + two-grid) and
its pure-bending plate (n = 13862).  Prints one line per variant, then one
JSON line; the JSON also goes to chiprun_out/rescue_lanes.json.

Run from the repository root:

    python3 .probes/rescue_lanes.py [--plates bench sol_s sol_s0 11910 21k
                                    13862]
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

SOL_TRUE = np.array([120e9, 8.5e9, 4.5e9, 0.30, 0.006])
SOL_S = np.array([0.7, 1.3, 0.6, 1.15, 0.5])
SOL_S0 = np.array([1.35, 0.70, 1.40, 0.85, 1.50])
MAX_ORACLE = 16          # splu points a plate (flagged lanes, worst first)


class Solver:
    """Switches the rescue cycles off by wrapping ``mixed._pgmres`` and
    counts the FGMRES cycles by wrapping ``mixed._pgmres_cycle``."""

    def __init__(self):
        from plate_inverse_problem_tpu_torch.ops import mixed
        self.mixed = mixed
        self.pgmres, self.cycle = mixed._pgmres, mixed._pgmres_cycle
        self.rescue, self.cycles = True, 0

        def pgmres(*a, **k):
            if not self.rescue:
                k["n_rescue"] = 0
            return self.pgmres(*a, **k)

        def cycle(*a, **k):
            self.cycles += 1
            return self.cycle(*a, **k)

        mixed._pgmres, mixed._pgmres_cycle = pgmres, cycle

    def sweep_s(self, p, freqs, params, rescue: bool) -> float:
        import torch
        self.rescue = rescue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.solveForward(freqs, params)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def diag(self, p, freqs, params, rescue: bool) -> tuple[dict, int]:
        self.rescue, self.cycles = rescue, 0
        d = p.diagnoseSweep(freqs, params)
        return d, self.cycles


def plate(sv: Solver, label: str, problems: dict, freqs, params) -> dict:
    """Every variant of one plate: ``problems`` maps a basis name to its
    Problem (one operator data and band basis)."""
    from chip_smoke import peak_points
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    variants = [(b, r) for b in problems for r in (False, True)]
    diags = {}
    for b, r in variants:
        diags[(b, r)] = sv.diag(problems[b], freqs, params, r)
    # the oracle points: the peaks, then the flagged lanes, worst first
    d0 = diags[(next(iter(problems)), False)][0]
    idx = list(peak_points(d0["fr"]))
    for (b, r), (d, _) in diags.items():
        bad = np.flatnonzero(~d["converged"])
        ratio = d["residual_norm"][bad] / d["target"][bad]
        idx += [int(i) for i in bad[np.argsort(-ratio)]]
    idx = sorted(dict.fromkeys(idx))[:MAX_ORACLE]
    any_p = next(iter(problems.values()))
    ref = splu_frf(any_p, freqs[idx], params)
    times = {v: [] for v in variants}
    for b, r in variants:                       # warm-up
        sv.sweep_s(problems[b], freqs, params, r)
    for v in variants + variants[::-1]:
        times[v].append(sv.sweep_s(problems[v[0]], freqs, params, v[1]))
    recs = []
    for (b, r) in variants:
        d, cycles = diags[(b, r)]
        bad = np.flatnonzero(~d["converged"])
        err = np.abs(d["fr"][idx] - ref) / np.abs(ref)
        rec = {"label": label, "n_free": any_p.n_free, "basis": b,
               "tier": list(problems[b]._tier), "rescue": r,
               "unconverged": int(bad.size),
               "unconverged_hz": [float(f) for f in freqs[bad]],
               "rn_over_target": [float(v) for v in
                                  d["residual_norm"][bad] / d["target"][bad]],
               "rn_fin_over_target": [
                   float(v) for v in
                   d["final_residual_norm"][bad] / d["target"][bad]],
               "cycles": cycles, "oracle_hz": [float(f) for f in freqs[idx]],
               "rel_err": [float(e) for e in err],
               "worst_rel_err": float(err.max()), "sweep_s": times[(b, r)]}
        recs.append(rec)
        fin = rec["rn_fin_over_target"]
        print(f"[rescue] {label} n={rec['n_free']} basis {b} rescue "
              f"{'on' if r else 'off'}: {bad.size} unconverged, rn/target "
              f"max {max(rec['rn_over_target'], default=0):.3g}, after the "
              f"band corrections max {max(fin, default=0):.3g}; {cycles} "
              f"cycles; worst rel err {rec['worst_rel_err']:.3e} over "
              f"{len(idx)} points; steady sweep "
              f"{', '.join(f'{t:.4f}' for t in times[(b, r)])} s",
              flush=True)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plates", nargs="+",
                    default=["bench", "sol_s", "sol_s0", "11910", "21k",
                             "13862"])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    import plate_inverse_problem_tpu_torch as pt

    if not torch.cuda.is_available():
        raise SystemExit("rescue_lanes: no CUDA device; nothing was run.")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    freqs = np.linspace(40.0, 600.0, 512)
    sv = Solver()

    def pair(**kw):
        """The tier's own basis and, on a dense tier, the other one on the
        same operator data and band basis."""
        p = cs.sh_i_problem(dev, **kw)
        od = p.getFRCore()[1]
        out = {"auto": p}
        if p._tier[1] == "dense":
            f32 = not p._tier[2]
            out["f32" if f32 else "f64"] = cs.sh_i_problem(
                dev, basis_f32=f32, opdata=od, **kw)
        return out

    sol = pt.get_material(1550.0, "sol", angles=(45.0,), E1=SOL_TRUE[0],
                          E2=SOL_TRUE[1], G12=SOL_TRUE[2], nu12=SOL_TRUE[3],
                          beta=SOL_TRUE[4])
    cases = {
        "bench": lambda: ("bench plate at the truth", pair(refine=1.0), None),
        "sol_s": lambda: ("SOL 45 deg at s", pair(refine=1.0, mat=sol),
                          SOL_TRUE * SOL_S),
        "sol_s0": lambda: ("SOL 45 deg at s0", pair(refine=1.0, mat=sol),
                           SOL_TRUE * SOL_S0),
        "11910": lambda: ("refine 3 at the truth", pair(refine=3.0), None),
        "21k": lambda: ("refine 4 at the truth", pair(refine=4.0), None),
        "13862": lambda: ("refine 4 pure bending at the truth",
                          pair(refine=4.0, accel=False), None),
    }
    recs = []
    for name in args.plates:
        label, problems, params = cases[name]()
        recs += plate(sv, label, problems, freqs, params)
        del problems
        torch.cuda.empty_cache()
    line = json.dumps({"card": card, "variants": recs})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rescue_lanes.json"),
              "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
