"""How far the FRF at a resonance peak can be trusted: the port's sweep, the
host f64 ``splu`` oracle and a refined oracle at bench.py's four points.

For each plate the probe builds the Problem ``--bases`` times (each build
draws a new ARPACK start vector, so a new band basis), runs the 512-point
sweep over 40-600 Hz ``--reps`` times on each, and prints at the four
points (3, the |FRF| peak, 256, 511) the relative error of every sweep
against

* ``splu``: one plain f64 complex LU solve per frequency;
* ``refined``: the same LU with ``oracle.REFINE_STEPS`` steps of iterative
  refinement whose residuals b - A u are computed in ``np.longdouble``
  (80-bit on x86) from the same f64 operator data — the solution of the f64
  system to ~1e-11 (``oracle.splu_frf``; ``splu`` is it with no steps).

and the distance between the two oracles.  Plates (``sh_i`` 100 x 20 x 2
mm, AP1030): ``symm`` isotropic steel without the accelerometer (the
pure-bending path), ``d4`` OrthotropicD4 and ``iso`` isotropic steel (the
3-field path); ``--refine`` sets the mesh (4: n = 13862 / 20916 / 20916).

Run from the repository root on a machine with a card (``--device cpu``
runs it on the CPU):
    python3 .probes/peak_floor.py --plates symm d4 iso [--bases 2 --reps 3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make(plate: str, refine: float, device):
    import plate_inverse_problem_tpu_torch as pt

    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=refine)
    if plate == "d4":
        mat = pt.get_material(7920.0, "orthotropic_d4", E1=210e9, E2=200e9,
                              G12=75e9, nu12=0.33, b1=0.003, b2=0.003,
                              b3=0.004, b4=0.0)
    else:
        mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                              beta=0.003)
    return pt.Problem(geom, mat, None if plate == "symm" else acc,
                      device=device)


def oracles(p, freqs):
    """(plain f64 splu, refined splu) FRFs at ``freqs``."""
    from plate_inverse_problem_tpu_torch import oracle

    steps = oracle.REFINE_STEPS
    oracle.REFINE_STEPS = 0
    try:
        plain = oracle.splu_frf(p, freqs)
    finally:
        oracle.REFINE_STEPS = steps
    return plain, oracle.splu_frf(p, freqs)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plates", nargs="+", default=["symm", "d4", "iso"])
    ap.add_argument("--refine", type=float, default=4.0)
    ap.add_argument("--bases", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    freqs = np.linspace(40.0, 600.0, 512)
    recs = []
    for plate in args.plates:
        refs = None
        for base in range(args.bases):
            t0 = time.perf_counter()
            p = make(plate, args.refine, dev)
            p.getFRCore()
            ctor = time.perf_counter() - t0
            for rep in range(args.reps):
                fr = p.solveForward(freqs).cpu().numpy()
                if refs is None:
                    idx = [3, int(np.argmax(np.abs(fr))), 256, 511]
                    t0 = time.perf_counter()
                    refs = oracles(p, freqs[idx])
                    o_s = time.perf_counter() - t0
                    gap = np.abs(refs[0] - refs[1]) / np.abs(refs[1])
                    print(f"[{plate}] n={p.n_free} points "
                          f"{np.round(freqs[idx], 3).tolist()} oracles in "
                          f"{o_s:.1f} s; |splu - refined| / |refined| "
                          + " ".join(f"{g:.2e}" for g in gap), flush=True)
                e_s, e_r = (np.abs(fr[idx] - o) / np.abs(o) for o in refs)
                print(f"[{plate}] basis {base} (ctor {ctor:.1f} s) sweep "
                      f"{rep}: vs splu " + " ".join(f"{e:.2e}" for e in e_s)
                      + "  vs refined " + " ".join(f"{e:.2e}" for e in e_r),
                      flush=True)
                recs.append({"plate": plate, "n_free": p.n_free,
                             "basis": base, "rep": rep,
                             "vs_splu": e_s.tolist(),
                             "vs_refined": e_r.tolist(),
                             "oracle_gap": gap.tolist()})
            del p
    print(json.dumps({"peak_floor": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
