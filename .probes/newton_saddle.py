"""The loss landscape where ``chip_smoke.py`` phase 10 (c)'s damped Newton
can stall, on the CPU: the bench plate (n = 1466) through the modal engine
(exact f64 derivatives), MSE_LOG_AFC against its own FRF at the truth
over 512 points, and at points of the Newton paths (theta / truth, read
off ``.probes/newton_spread.py``'s output) the value, the gradient and
the Hessian in the optimizer's scaled variables x = theta / theta_0
(theta_0 = truth x (1.05, 1.02, 1.2)): the Hessian's eigenvalues and
eigenvectors, the damped Newton step and its slope against the gradient
(> 0: not a descent direction, so ``optimize_newton`` falls back to -g).

Run from the repository root (a few minutes on 4 CPU threads):
  python3 .probes/newton_saddle.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# theta / truth: the iterate before the step across beta = 0, two points
# where runs crawled, one from which a run went on to the truth
POINTS = {"before the crossing": (1.0006, 1.0185, 0.5394),
          "crawl A": (1.0030, 1.0210, -0.5278),
          "crawl B": (1.0030, 1.0209, -0.5054),
          "left for the truth": (1.0031, 1.0210, -0.5959)}


def main() -> int:
    import torch

    import chip_smoke as cs

    torch.set_num_threads(4)
    freqs = np.linspace(40.0, 600.0, cs.N_FREQ)
    p = cs.sh_i_problem(torch.device("cpu"), 1.0, engine="modal")
    truth = np.asarray(p.parameters, np.float64)
    th0 = truth * np.asarray(cs.START)
    loss = p.getLossFunction(freqs, p.solveForward(freqs).numpy(),
                             "MSE_LOG_AFC")
    for label, rel in POINTS.items():
        v, g, H = (np.asarray(a) for a in loss.value_grad_hessian(
            np.asarray(rel) * truth))
        gs, Hs = g * th0, H * np.outer(th0, th0)
        w, V = np.linalg.eigh(0.5 * (Hs + Hs.T))
        lam = 1e-8 * np.trace(Hs) / 3
        step = np.linalg.solve(Hs + lam * np.eye(3), -gs)
        print(f"[saddle] {label} {rel}: f {float(v):.4e}; scaled gradient "
              f"{np.array2string(gs, precision=3)}; Hessian eigenvalues "
              f"{np.array2string(w, precision=3)}, eigenvectors (rows) "
              f"{np.array2string(V.T, precision=4)}; Newton step "
              f"{np.array2string(step, precision=4)}, step . g "
              f"{step @ gs:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
