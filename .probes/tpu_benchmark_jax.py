"""The JAX package's own CPU run of ``examples/tpu_benchmark.py``'s workflow,
the reference that ``chip_smoke.py`` phase 9 (d) holds the port to (no GPU
needed).

The ``sh_i`` strip 100 x 20 x 2 mm at refine = 1 (n = 1466), isotropic steel
(7920, E = 200e9, G = 75e9, beta = 0.003), AP1030, the package's default
engine for the CPU; a 3000-point forward sweep over 40-600 Hz; then three
inverse runs on that sweep, all ``MSE_LOG_AFC`` from ``[0.1, 0.1, 0.2]``
relative (``use_rel``), compressed to 200 points (``comp_alg`` 1):

* ``gd``: ``N_steps``, h = 0.001, f_min = 1e-10 (the example's call);
* ``gd_scaled``: the same with ``use_scaling=True``;
* ``cd_mem_scaled``: ``cd_mem`` with ``use_scaling=True``, 5 cycles,
  h = 0.001, f_min = 1e-10.

Prints each phase's seconds, then one JSON line with every result's x,
f_history, niter and status.

Run from the repository root:
    JAX_PLATFORMS=cpu python3 .probes/tpu_benchmark_jax.py [--steps 20]
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

N_FREQ = 3000
N_COMP = 200
START = [0.1, 0.1, 0.2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cd-cycles", type=int, default=5)
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import plate_inverse_problem_tpu as pip

    acc = pip.Accelerometer("AP1030")
    geom = pip.Geometry("sh_i", acc,
                        pip.GeometryParams(100e-3, 20e-3, 2e-3, None, None))
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    t0 = time.perf_counter()
    p = pip.Problem(geom, mat, acc)
    freq = np.linspace(40, 600, N_FREQ)
    fr = np.asarray(p.solveForward(freq))
    print(f"ctor + sweep {time.perf_counter() - t0:.1f} s, engine "
          f"{p._resolve_engine()}, n_free {p.n_free}, checksum "
          f"{np.sum(np.abs(fr))!r}", flush=True)
    rec = {"engine": p._resolve_engine(), "n_free": int(p.n_free),
           "checksum": float(np.sum(np.abs(fr))), "steps": args.steps,
           "cd_cycles": args.cd_cycles, "runs": {}}
    runs = {
        "gd": ("gd", dict(N_steps=args.steps), False),
        "gd_scaled": ("gd", dict(N_steps=args.steps), True),
        "cd_mem_scaled": ("cd_mem", dict(N_steps=args.cd_cycles), True),
    }
    for name, (opt, kw, scaled) in runs.items():
        t0 = time.perf_counter()
        res = p.solveInverse(
            START, "MSE_LOG_AFC", opt, ref_fr=[freq, fr], use_rel=True,
            use_scaling=scaled, compression=(True, N_COMP), log=False,
            report=False, h=0.001, f_min=1e-10, **kw)
        dt = time.perf_counter() - t0
        rec["runs"][name] = {
            "x": [float(v) for v in np.asarray(res.x)],
            "f_history": [float(v) for v in res.f_history],
            "niter": int(res.niter), "status": res.status, "seconds": dt}
        print(f"{name}: {dt:.1f} s, x {np.asarray(res.x)!r}, niter "
              f"{res.niter}, {res.status}", flush=True)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
