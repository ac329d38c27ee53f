"""Multi-device frequency-sweep demo (the JAX package's
``examples/multichip.py`` on the port).

Shards the sweep, three training steps and a Levenberg-Marquardt-damped
Gauss-Newton loop over the ranks (a ``freq`` x ``dof`` mesh, dof = 2 from
four ranks up) on the ``symm`` ny = 2 plate, 64 frequencies over 40-600 Hz.
Prints what the JAX script prints.  One rank per card:

    torchrun --nproc-per-node 4 -m plate_inverse_problem_tpu_torch.parallel
    python -m plate_inverse_problem_tpu_torch.parallel            # one card
    python -m plate_inverse_problem_tpu_torch.parallel --device cpu
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import Accelerometer, Geometry, GeometryParams, Problem, get_material
from .freq_shard import (
    init, make_mesh, shard_frequencies, sharded_fr_function, sharded_gn_step,
    sharded_train_step,
)

N_FREQ = 64
START = np.array([1.05, 1.05, 1.2])


def workflow(device="cuda", engine=None, echo=print) -> dict:
    """The demo on the process group (or a world of one without one):
    returns the FRF sum, the training losses, the Gauss-Newton record
    (|r|^2, damping, accepted) per iteration and the final theta.
    ``engine`` None is the JAX package's choice for the device, as the
    JAX script's ``Problem(geom, mat, acc)`` makes it (modal on the CPU,
    mixed on the card)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    acc = Accelerometer("AP1030")
    geom = Geometry("symm", acc,
                    GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None), ny=2)
    mat = get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    p = Problem(geom, mat, acc, device=device, engine=engine)
    mesh = make_mesh(dof_axis=2 if world % 2 == 0 and world >= 4 else 1,
                     device=p.device)
    echo(f"device mesh: {mesh.shape}")

    freqs = np.linspace(40, 600, N_FREQ)
    fn = sharded_fr_function(p, mesh)
    fr = fn(shard_frequencies(mesh, freqs), p.parameters)[:N_FREQ]
    out = {"frf_sum": float(fr.abs().sum())}
    echo(f"sharded FRF sum: {out['frf_sum']:.4f}")

    step = sharded_train_step(p, mesh)
    ref = fr.cpu().numpy()
    truth = np.asarray(p.parameters, np.float64)
    theta = truth * START
    out["losses"] = []
    for it in range(3):
        loss, _, theta = step(freqs, ref, theta)
        out["losses"].append(float(loss))
        echo(f"iter {it}: loss={float(loss):.6e}")

    # Gauss-Newton over the mesh: gn() returns |r|^2 at the CURRENT theta
    # and the proposed update, so a proposal is judged at the next call;
    # a rejection re-proposes from the same theta with 10x damping
    theta = torch.as_tensor(truth * START, device=p.device)
    gn = sharded_gn_step(p, mesh, kind="log_afc")
    lam = 1e-2
    rsq, theta_prop = gn(freqs, ref, theta, damping=lam)
    out["gn"] = []
    for it in range(10):
        rsq_prop, theta_next = gn(freqs, ref, theta_prop, damping=lam)
        if rsq_prop <= rsq:
            theta, rsq, theta_prop = theta_prop, rsq_prop, theta_next
            lam = max(lam / 3.0, 1e-4)
            out["gn"].append((rsq, lam, True))
            echo(f"GN iter {it}: |r|^2={rsq:.6e} (lambda={lam:.0e})")
        else:
            lam *= 10.0
            _, theta_prop = gn(freqs, ref, theta, damping=lam)
            out["gn"].append((rsq_prop, lam, False))
            echo(f"GN iter {it}: rejected ({rsq_prop:.3e} > {rsq:.3e}), "
                 f"lambda -> {lam:.0e}")
    out["theta"] = theta.cpu().numpy()
    out["rsq"] = rsq
    err = out["theta"] / truth - 1
    echo(f"recovered param rel err: {np.array2string(err, precision=2)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (this rank\'s card, cuda:LOCAL_RANK) or '
                         '"cpu"')
    ap.add_argument("--engine", default=None,
                    choices=("mixed", "modal", "direct"),
                    help="the sweep engine (default: the JAX package's "
                         "choice for the device)")
    args = ap.parse_args()
    device = args.device
    if "RANK" in os.environ:              # started by torchrun
        device = init(device=device)
    try:
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        workflow(device, args.engine,
                 echo=print if rank0 else (lambda *a: None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
