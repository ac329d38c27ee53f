"""The JAX package's own CPU run of ``examples/basics.py``'s workflow, the
reference that ``chip_smoke.py`` phase 11 (f) holds the port's modal engine
to (no GPU needed).

The script's calls exactly: the ``symm`` template 100 x 20 x 2 mm with the
AP1030 at x = 10 mm (the template's default mesh density), isotropic steel
(7920, E = 200e9, G = 75e9, beta = 0.003), the package's default CPU engine
(modal); a 50-point sweep over 40-600 Hz; ``solveInverseLocal`` by
``grad_descent`` on MSE_LOG_AFC from [0.1, 0.1, 0.2] relative
(``use_rel``), uncompressed, N_steps = 2, h = 0.001, f_min = 1e-5 (no
report or log files); then the sweeps at the start and at the result.
Prints the script's four sums with every digit, then one JSON line.

Run from the repository root:
    JAX_PLATFORMS=cpu python3 .probes/basics_jax.py
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import plate_inverse_problem_tpu as pip

    t0 = time.perf_counter()
    acc = pip.Accelerometer("AP1030")
    geom = pip.Geometry("symm", acc,
                        pip.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None))
    mat = pip.get_material(7920.0, "isotropic", E=200 * 1e9, G=75 * 1e9,
                           beta=0.003)
    p = pip.Problem(geom, mat, acc)
    N = 50
    freq = np.linspace(40, 600, N)
    fr = np.asarray(p.solveForward(freq))
    p0 = [0.1, 0.1, 0.2]
    res = p.solveInverseLocal(
        p0, "MSE_LOG_AFC", "grad_descent", ref_fr=[freq, fr],
        compression=(False, N), use_rel=True, report=False, log=False,
        N_steps=2, h=0.001, f_min=1e-5)
    r1 = np.asarray(p.solveForward(freq, (np.array(p0) + 1) * p.parameters))
    r2 = np.asarray(p.solveForward(freq, res.x))
    sums = {"FR": float(np.sum(np.abs(fr))),
            "Initial": float(np.sum(np.abs(r1))),
            "After": float(np.sum(np.abs(r2))),
            "F_hist": float(np.sum(np.abs(res.f_history)))}
    for k, v in sums.items():
        print(f"{k}: {v!r}")
    print(json.dumps({"engine": p._engine(), "n_free": int(p.n_free),
                      "sums": sums, "x": [float(v) for v in res.x],
                      "f_history": [float(v) for v in res.f_history],
                      "niter": int(res.niter), "status": str(res.status),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
