"""What the dense apply by fixed row blocks costs the unsharded two-grid
path at 20916 DOF on one card, and whether a dof rank's share of the
rectangular prolongation's batched GEMMs has the whole GEMMs' bits.

For one tree of the package (``--tree``: the repository, or a checkout of
another commit unpacked beside it) it builds the two kernels, the 21k
``sh_i`` Problem of ``chip_smoke.py`` phase 4 and runs, as phases 4 and 6
do: the 512-point sweep (first and steady), one adjoint log-AFC r + J at
theta_0 = truth x ``START`` (first and steady) and ``GN_STEPS``
Gauss-Newton iterations, each with its K1 launches and seconds.

``--variants`` (this repository's tree only) repeats the three on the same
Problem with the unsharded path's two changes of the coarse inverse undone
one at a time and together: ``one_gemm`` applies ``mg_Kcinv`` by one GEMM
instead of one a fixed row block, ``col_major`` holds it in the
column-major layout a host splu's solve gives (the same values).

``--bits`` (this repository's tree only) holds, at the 21k shapes, each
dof rank's prolongation rows (``rect_band_mv_rows`` on a copy of its block
rows of ``mg_Pt``) and restriction window terms (``restrict_windows``)
against the whole products' rows, for dof axes of 2, 3, 4 and 8 and 1 to
256 lanes, bit for bit; and times the whole prolongation and restriction
at the sweep's 128 lanes (``chip_smoke.time_ms``: device and host ms a
call) against one batched GEMM over all block rows (``torch.einsum``, the
products before they ran by fixed groups).

Run from the repository root:
  python3 .probes/twogrid_cost_probe.py [--tree DIR] [--label NAME]
      [--variants] [--bits]
Prints one JSON line a run and writes them to
``chiprun_out/twogrid_cost/<label>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync():
    import torch
    torch.cuda.synchronize()


def path_costs(cs, p, freqs, fr_truth) -> dict:
    """K1 launches and seconds of the sweep, one r + J and GN on ``p``."""
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    k1 = band_kernel.band_mv_f32_cuda
    out = {}
    secs = []
    for _ in range(2):
        k1.launches = 0
        _sync()
        t0 = time.perf_counter()
        fr = p.solveForward(freqs)
        _sync()
        secs.append(time.perf_counter() - t0)
    fr = fr.cpu().numpy()
    out["sweep"] = {"first_s": secs[0], "steady_s": secs[1],
                    "k1": k1.launches,
                    "rel_vs_truth_frf": float(np.max(np.abs(fr - fr_truth)
                                                     / np.abs(fr_truth)))}
    th0 = np.asarray(p.parameters, np.float64) * np.asarray(cs.START)
    rf = p.getResidualFunction(freqs, fr_truth, kind="log_afc")
    secs = []
    for _ in range(2):
        k1.launches = 0
        _sync()
        t0 = time.perf_counter()
        r, _ = rf.value_and_jac(th0)
        _sync()
        secs.append(time.perf_counter() - t0)
    out["rj"] = {"first_s": secs[0], "steady_s": secs[1], "k1": k1.launches,
                 "r2": float((r.cpu().numpy() ** 2).sum())}
    k1.launches = 0
    _sync()
    t0 = time.perf_counter()
    res = p.solveInverse(th0, "MSE_LOG_AFC", "gn", ref_fr=(freqs, fr_truth),
                         use_scaling=True, N_steps=cs.GN_STEPS, report=False,
                         log=False)
    _sync()
    gn_s = time.perf_counter() - t0
    truth = np.asarray(p.parameters, np.float64)
    out["gn"] = {"s": gn_s, "iterations": len(res.f_history),
                 "s_per_iter": gn_s / max(1, len(res.f_history)),
                 "k1": k1.launches,
                 "rel_err": ((np.abs(res.x) - truth) / truth).tolist()}
    return out


def variants(cs, p, freqs, fr_truth) -> dict:
    """``path_costs`` with the coarse inverse's apply and layout as the
    tree has them, and each undone."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import mg

    od = p.operator_data()
    kc = od["mg_Kcinv"]
    kc_col = kc.T.contiguous().T
    assert torch.equal(kc_col, kc) and kc_col.stride() == (1, kc.shape[0])
    blocked = mg.dense_apply

    def one_gemm(inv, x):
        return torch.matmul(x.to(inv.dtype), inv.T)

    out = {}
    for name, apply, inv in (("one_gemm", one_gemm, kc),
                             ("col_major", blocked, kc_col),
                             ("one_gemm+col_major", one_gemm, kc_col),
                             ("as_is", blocked, kc)):
        mg.dense_apply, od["mg_Kcinv"] = apply, inv
        try:
            out[name] = path_costs(cs, p, freqs, fr_truth)
        finally:
            mg.dense_apply, od["mg_Kcinv"] = blocked, kc
        print(json.dumps({"variant": name, **out[name]}), flush=True)
    return out


def rect_bits(p) -> dict:
    """Each dof rank's prolongation rows and restriction window terms
    against the whole products' rows at the 21k shapes."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.band import (
        rect_band_mv, rect_band_mv_rows, restrict_windows)
    from plate_inverse_problem_tpu_torch.parallel.freq_shard import (
        band_range)

    od, rl = p.operator_data(), p._mg_rl
    Pt, slots = od["mg_Pt"], od["mg_slots"]
    rng = np.random.default_rng(0)
    out = {"nb": rl.nb, "b": rl.b, "bc": rl.bc, "nd": rl.nd, "cases": 0,
           "mismatches": []}
    for lanes in (1, 2, 6, 16, 32, 64, 100, 128, 256):
        xc = torch.as_tensor(rng.standard_normal(
            (lanes, rl.n_coarse)).astype(np.float32), device=Pt.device)
        rf = torch.as_tensor(rng.standard_normal(
            (lanes, rl.n_fine)).astype(np.float32), device=Pt.device)
        y = rect_band_mv(Pt, xc, rl, slots)
        w = restrict_windows(Pt, rf, rl, 0)
        for d in (2, 3, 4, 8):
            for i in range(d):
                q0, q1 = band_range(rl.nb, d, i)
                lo, hi = q0 * rl.b, min(rl.n_fine, q1 * rl.b)
                rows = Pt[q0:q1].clone()
                yr = rect_band_mv_rows(rows, xc, rl, slots, q0)
                wr = restrict_windows(rows, rf[:, lo:hi].contiguous(), rl,
                                      q0)
                out["cases"] += 2
                for what, a, b in (("prolong", yr, y[:, lo:hi]),
                                   ("restrict", wr, w[:, q0:q1])):
                    if not torch.equal(a, b):
                        out["mismatches"].append(
                            {"what": what, "lanes": lanes, "d": d, "rank": i,
                             "max_abs": float((a - b).abs().max())})
    print(json.dumps({"rect_bits": out}), flush=True)
    return out


def product_times(cs, p, lanes: int = 128) -> dict:
    """Device and host ms a call of the whole prolongation and restriction
    (by fixed groups) and of one einsum over all block rows each."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.band import (
        rect_band_mv, rect_band_tmv)

    od, rl = p.operator_data(), p._mg_rl
    Pt, slots = od["mg_Pt"], od["mg_slots"]
    rng = np.random.default_rng(1)
    xc = torch.as_tensor(rng.standard_normal(
        (lanes, rl.n_coarse)).astype(np.float32), device=Pt.device)
    rf = torch.as_tensor(rng.standard_normal(
        (lanes, rl.n_fine)).astype(np.float32), device=Pt.device)

    def einsum_mv():
        xs = torch.zeros(lanes, rl.nb * rl.bc, device=Pt.device)
        xs[:, slots] = xc
        xm = torch.nn.functional.pad(xs.reshape(lanes, rl.nb, rl.bc),
                                     (0, 0, rl.hw, rl.hw))
        win = torch.stack([xm[:, d:d + rl.nb] for d in range(rl.nd)], 2)
        y = torch.einsum("qic,Bqc->Bqi", Pt,
                         win.reshape(lanes, rl.nb, rl.nd * rl.bc))
        return y.reshape(lanes, -1)[:, :rl.n_fine]

    def einsum_tmv():
        rp = torch.nn.functional.pad(rf, (0, rl.nb * rl.b - rl.n_fine))
        w = torch.einsum("qic,Bqi->Bqc", Pt, rp.reshape(lanes, rl.nb, rl.b))
        w = w.reshape(lanes, rl.nb, rl.nd, rl.bc)
        acc = torch.zeros(lanes, rl.nb + 2 * rl.hw, rl.bc, device=Pt.device)
        for d in range(rl.nd):
            acc[:, d:d + rl.nb] += w[:, :, d]
        return acc[:, rl.hw:rl.hw + rl.nb].reshape(lanes, -1)[:, slots]

    assert torch.allclose(einsum_mv(), rect_band_mv(Pt, xc, rl, slots),
                          rtol=1e-4, atol=1e-4)
    assert torch.allclose(einsum_tmv(), rect_band_tmv(Pt, rf, rl, slots),
                          rtol=1e-4, atol=1e-4)
    out = {"lanes": lanes}
    for name, fn in (("prolong_groups", lambda: rect_band_mv(Pt, xc, rl,
                                                             slots)),
                     ("prolong_one_einsum", einsum_mv),
                     ("restrict_groups", lambda: rect_band_tmv(Pt, rf, rl,
                                                               slots)),
                     ("restrict_one_einsum", einsum_tmv)):
        dev_ms, host_ms = cs.time_ms(fn, reps=50)
        out[name] = {"device_ms": dev_ms, "host_ms": host_ms}
    print(json.dumps({"product_times": out}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--bits", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    if not torch.cuda.is_available():
        raise SystemExit("twogrid_cost_probe: no CUDA device.")
    if (args.variants or args.bits) and tree != ROOT:
        raise SystemExit("--variants and --bits run on this repository's "
                         "tree only")
    dev = torch.device("cuda")
    rec = {"label": args.label, "card": cs.card_info()}
    band_kernel.build()
    csr_kernel.build()
    t0 = time.perf_counter()
    p = cs.sh_i_problem(dev, 4.0)
    p.getFRCore()
    _sync()
    rec["ctor_s"] = time.perf_counter() - t0
    freqs = np.linspace(40.0, 600.0, cs.N_FREQ)
    fr_truth = p.solveForward(freqs).cpu().numpy()
    if args.bits:
        rec["rect_bits"] = rect_bits(p)
        rec["product_times"] = product_times(cs, p)
    rec["path"] = path_costs(cs, p, freqs, fr_truth)
    print(json.dumps(rec), flush=True)
    if args.variants:
        rec["variants"] = variants(cs, p, freqs, fr_truth)
    out = os.path.join(ROOT, "chiprun_out", "twogrid_cost")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{args.label}.jsonl"), "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return 0 if not rec.get("rect_bits", {}).get("mismatches") else 1


if __name__ == "__main__":
    sys.exit(main())
