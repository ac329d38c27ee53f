"""How accurate the dense-preconditioner tier is, and why its inverse is f64
in the port (CPU, no GPU needed).

For the ``sh_i`` strip (isotropic steel, AP1030) at refine = 1, 2, 2.5 and
3 (n = 1466, 5428, 8568, 11910; "auto" resolves to the dense tier at all
four), runs the port's sweep at bench.py's 4 frequencies (the first,
middle and last of 512 over 40-600 Hz and the 150.685 Hz peak) with three
dense inverses of the same equilibrated reference stiffness A:

* ``f64``: the port's (``ops/dense.inv_refined``: f64 LU inverse, applied
  in f64);
* ``jax_f32``: the JAX package's algorithm (f32 LU inverse, three f32
  Newton-Schulz steps, applied in f32 with one f32 refinement round);
* ``f64_as_f32``: the f64 inverse rounded to f32, applied like ``jax_f32``.

For each it prints max |A X - I| (in f64), the worst relative FRF error
against the host f64 splu oracle, and the largest relative residual
||A(omega) u - b|| / ||b|| of the returned solutions; for n <= 5428 also
kappa(A).  ``--jax`` also runs the JAX package itself ("auto", its own
CPU path) at each size.

Run from the repository root:  python3 .probes/dense_tier_accuracy.py [--jax]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REFINES = (1.0, 2.0, 2.5, 3.0)
GP = (100e-3, 20e-3, 2e-3, None, None)
MAT = dict(E=200e9, G=75e9, beta=0.003)


def bench_points() -> np.ndarray:
    """bench.py's 4 points of 512 over 40-600 Hz: 3, the |FRF| peak (index
    101, 150.685 Hz, at every refinement here), 256 and 511."""
    return np.linspace(40.0, 600.0, 512)[[3, 101, 256, 511]]


def inverses(A64):
    """The three inverses of the equilibrated matrix A64 (torch, f64); the
    JAX algorithm starts from its f32 rounding, as the JAX package does."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.dense import inv_refined

    A32 = A64.float()
    d = torch.diagonal(A32)
    s = 1.0 / torch.sqrt(torch.where(d.abs() > 0, d.abs(), torch.ones_like(d)))
    At = A32 * s[:, None] * s[None, :]
    X = torch.linalg.inv(At)
    for _ in range(3):                 # f32 Newton-Schulz, as JAX
        X = X @ (2.0 * torch.eye(At.shape[0]) - At @ X)
    jax_f32 = X * s[None, :] * s[:, None]
    f64 = inv_refined(A64)
    return {"f64": f64, "jax_f32": jax_f32, "f64_as_f32": f64.float()}


def run(refine: float, with_jax: bool) -> dict:
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops.scatter import to_dense
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    freqs = bench_points()
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", **MAT)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), refine=refine)
    p = pt.Problem(geom, mat, acc, device="cpu")
    core, od = p.getFRCore()
    n = p.n_free
    ref = splu_frf(p, freqs)
    A64 = to_dense(torch.as_tensor(
        p._reference_stiffness_flat()
        * p._eq_scale[p.op.pattern.rows] * p._eq_scale[p.op.pattern.cols]),
        od["rows"].new_tensor(p.op.pattern.rows),
        od["cols"].new_tensor(p.op.pattern.cols), n)
    if p._band_layout is not None:
        perm = torch.as_tensor(p._band_layout.perm)
        A64 = A64[perm][:, perm]
    A32 = A64.float()
    rec = {"refine": refine, "n": n, "tier": list(p._tier)}
    if n <= 6000:
        rec["kappa"] = float(np.linalg.cond(A64.numpy()))
    base = {k: v for k, v in od.items() if k != "invK64"}
    th = torch.as_tensor(p.parameters)
    fr = torch.as_tensor(freqs)
    for name, X in inverses(A64).items():
        res_inv = float((A64 @ X.double() - torch.eye(n)).abs().max())
        odv = dict(base, invK64=X) if X.dtype == torch.float64 else \
            dict(base, invK32=X, Kref32=A32.reshape(-1)[
                od["rows"] * n + od["cols"]])
        q = pt.Problem(geom, mat, acc, device="cpu", opdata=odv)
        y = q.solveForward(freqs).numpy()
        qc, qod = q.getFRCore()
        U = qc.sweep_u(fr, th, qod)
        R = qc.apply_res(fr, th, qod, *U)               # A u - b
        b = qc.apply_res(fr, th, qod, torch.zeros_like(U[0]),
                         torch.zeros_like(U[1]))         # -b
        rres = float(((R[0] ** 2 + R[1] ** 2).sum(1).sqrt()
                      / (b[0] ** 2 + b[1] ** 2).sum(1).sqrt()).max())
        rec[name] = {"max_abs_AX_minus_I": res_inv,
                     "worst_rel_err": float((np.abs(y - ref) / ref).max()),
                     "max_rel_residual": rres}
        print(f"[dense-acc] n={n} {name:10s}: max|AX-I| {res_inv:.3e}  "
              f"worst rel err {rec[name]['worst_rel_err']:.3e}  max "
              f"||Au-b||/||b|| {rres:.3e}", flush=True)
    if with_jax:
        import jax

        jax.config.update("jax_enable_x64", True)
        import plate_inverse_problem_tpu as pip

        jacc = pip.Accelerometer("AP1030")
        jmat = pip.get_material(7920.0, "isotropic", **MAT)
        jgeom = pip.Geometry("sh_i", jacc, pip.GeometryParams(*GP),
                             refine=refine)
        pj = pip.Problem(jgeom, jmat, jacc, engine="mixed")
        yj = np.asarray(pj.getFRFunction()(freqs, np.asarray(pj.parameters)))
        rec["jax_package"] = float((np.abs(yj - ref) / ref).max())
        print(f"[dense-acc] n={n} the JAX package ('auto', CPU): worst rel "
              f"err {rec['jax_package']:.3e}", flush=True)
    print(f"[dense-acc] {json.dumps(rec)}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX package itself at each size")
    ap.add_argument("--refine", type=float, action="append",
                    help="only these refinements (default: 1, 2, 2.5, 3)")
    args = ap.parse_args()
    recs = [run(r, args.jax) for r in (args.refine or REFINES)]
    print(json.dumps(recs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
