"""The JAX package's own CPU run of the multi-cut orthotropic identification
that ``chip_smoke.py`` phase 8 (a) runs on the card (no GPU needed).

``examples/joint_identification.py`` at the bench plate's size: the ``sh_i``
strip 100 x 20 x 2 mm at refine = 1 (n = 1466, AP1030), three SOL cuts at
0/90/45 degrees (density 1550) sharing theta = [E1, E2, G12, nu12, beta],
TRUE = [120e9, 8.5e9, 4.5e9, 0.30, 0.006]; synthetic FRFs from the mixed
engine at TRUE over 512 points 40-600 Hz; a ``JointResidual`` of theta-
scaled ``log_afc`` residuals (theta = s * TRUE); ``optimize_gauss_newton``
from s0 = [1.35, 0.70, 1.40, 0.85, 1.50], 30 steps.  Prints every
iterate's loss, seconds and relative error, then one JSON line with the
history (``--out`` also writes it to a file).

Run from the repository root:
    JAX_PLATFORMS=cpu python3 .probes/joint_identification_jax.py [--out F]
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
os.environ.setdefault("JAX_PLATFORMS", "cpu")

TRUE = np.array([120e9, 8.5e9, 4.5e9, 0.30, 0.006])
ANGLES = (0.0, 90.0, 45.0)
S0 = np.array([1.35, 0.70, 1.40, 0.85, 1.50])
N_STEPS = 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON record here")
    ap.add_argument("--steps", type=int, default=N_STEPS)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import plate_inverse_problem_tpu as pip
    from plate_inverse_problem_tpu.optimize.second_order import (
        JointResidual, optimize_gauss_newton)

    freqs = np.linspace(40.0, 600.0, 512)
    t0 = time.perf_counter()
    problems, refs = [], []
    for a in ANGLES:
        acc = pip.Accelerometer("AP1030")
        geom = pip.Geometry("sh_i", acc,
                            pip.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                            refine=1.0)
        mat = pip.get_material(1550.0, "sol", angles=(a,), E1=TRUE[0],
                               E2=TRUE[1], G12=TRUE[2], nu12=TRUE[3],
                               beta=TRUE[4])
        p = pip.Problem(geom, mat, acc, engine="mixed")
        problems.append(p)
        refs.append(np.asarray(p.getFRFunction()(freqs, TRUE)))
    print(f"[setup] 3 cuts n={problems[0].n_free}, data in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    stamps = []
    rs =[p.getResidualFunction(freqs, fr.astype(complex), "log_afc",
                                scaling_params=TRUE)
          for p, fr in zip(problems, refs)]
    joint = JointResidual(rs)
    joint_value_and_jac = joint.value_and_jac

    def value_and_jac(s):
        stamps.append(time.perf_counter())
        return joint_value_and_jac(s)

    joint.value_and_jac = value_and_jac
    t0 = time.perf_counter()
    out = optimize_gauss_newton(joint, S0, N_steps=args.steps)
    stamps.append(time.perf_counter())
    iter_s = list(np.diff(stamps))
    for k, (f, x, s) in enumerate(zip(out.f_history, out.x_history, iter_s)):
        err = np.asarray(x) - 1.0
        print(f"[gn] iterate {k}: loss {f:.6e}  {s:.3f} s  rel err "
              + ", ".join(f"{v:+.3e}" for v in err), flush=True)
    xf = np.asarray(out.x)
    rec = {"n_free": problems[0].n_free, "engine": "mixed (JAX CPU)",
           "f_history": [float(f) for f in out.f_history],
           "iter_s": [float(s) for s in iter_s],
           "s_final": [float(v) for v in xf],
           "rel_err": [float(v) for v in (np.abs(xf * TRUE) - TRUE) / TRUE],
           "status": out.status, "wall_s": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
