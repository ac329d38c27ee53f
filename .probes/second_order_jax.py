"""The JAX package's own run of chip_smoke.py's phase 10 (c) inverse calls
on the CPU: the bench plate (sh_i refine = 1, n = 1466, isotropic steel,
AP1030), 512 points over 40-600 Hz, the FRF at the truth from the direct
engine (an exact LU per frequency), ``solveInverse`` from theta_0 = truth
x (1.05, 1.02, 1.2) with ``use_scaling``.

    JAX_PLATFORMS=cpu python3 .probes/second_order_jax.py gn MSE \\
        "dict(N_steps=30)"
    JAX_PLATFORMS=cpu python3 .probes/second_order_jax.py lbfgs \\
        MSE_LOG_AFC "dict(N_steps=100)"

Prints the status, the number of iterations, the final loss and relative
error and the loss history (GN on MSE, 30 steps: ~2000 s on 8 CPU cores).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("PIP_TPU_PRECISION", "x64")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import plate_inverse_problem_tpu as pip  # noqa: E402


def main() -> int:
    opt, loss_type, kw = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    acc = pip.Accelerometer("AP1030")
    geom = pip.Geometry("sh_i", acc,
                        pip.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                        refine=1.0)
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    p = pip.Problem(geom, mat, acc, engine="direct", chunk=64)
    freqs = np.linspace(40, 600, 512)
    truth = np.asarray(p.parameters)
    th0 = truth * np.array([1.05, 1.02, 1.2])
    fr = np.asarray(p.getFRFunction()(freqs, truth))
    t = time.time()
    res = p.solveInverse(th0, loss_type, opt, ref_fr=(freqs, fr),
                         use_scaling=True, report=False, log=False, **kw)
    err = (np.abs(np.asarray(res.x)) - truth) / truth
    print(opt, loss_type, res.status, len(res.f_history), "f",
          float(res.f), "err", err, "s", time.time() - t, flush=True)
    print([float(f) for f in res.f_history])
    return 0


if __name__ == "__main__":
    sys.exit(main())
