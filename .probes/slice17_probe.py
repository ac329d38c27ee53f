"""Phase 15 of ``chip_smoke.py`` (the scale tiers) on one card, without the
rest of the script: builds ``csrc/band_mv.cu`` and ``csrc/csr_mv.cu`` (one
nvcc each, at once), prints the card's name and power limit, then builds
what phase 15 (c) reads from phases 8 (b) and 10 (b) (the 21k
OrthotropicD4 Problem, its adjoint r + J at the budget's blocks and its
forward-mode r + J) and runs ``chip_smoke.slice17``.  ``--wide`` runs
phase 14 (g) alone instead (``chip_smoke.dof_wide``: the bench two-grid on
8 gloo ranks of the card), each rank under cProfile (rank 0's 40 costliest
calls by cumulative time printed, every rank's in
``build/slice17/g/prof{r}.txt``).  ``--diagnose 6,9`` builds each refine
level's Problem and prints what its sweep rests on: ``diagnoseSweep``'s
convergence signal, the band basis's modes, the two-grid cycle's
contraction as a stationary iteration with its coarse inverse as built
and in f64 (and the sweep on the f64 one against the refined splu), the
coarse inverse against the coarse operator, P^T K P through the
rectangular band against it, and K3's one-lane panel products.  Writes
the record to ``build/slice17/slice17.json``; exits 1 if a check fails.

Run from the repository root:
    python3 .probes/slice17_probe.py [--wide | --diagnose 6,9]
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join("build", "slice17")


def profiled_checks(rank, dev, out_dir, spec):
    """``ranks.sharded_checks`` under cProfile; writes the 40 costliest
    calls by cumulative time beside the rank's record."""
    from plate_inverse_problem_tpu_torch.parallel import ranks

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        ranks.sharded_checks(rank, dev, out_dir, spec)
    finally:
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(
            40)
        with open(os.path.join(out_dir, f"prof{rank}.txt"), "w") as fh:
            fh.write(f"rank {rank}: {time.perf_counter() - t0:.2f} s in "
                     "sharded_checks\n" + buf.getvalue())


def wide(cs, dev) -> dict:
    """Phase 14 (g) with every rank profiled."""
    from plate_inverse_problem_tpu_torch.parallel import ranks

    real = ranks.sharded_checks
    out_dir = os.path.join(OUT, "g")
    ranks.sharded_checks = profiled_checks
    failed = []
    try:
        rec = cs.dof_wide(dev, out_dir, failed)
    finally:
        ranks.sharded_checks = real
    recs = ranks.load(out_dir, cs.DOF_WIDE)
    for r, g in enumerate(recs):
        m = g["meshes"][0]
        print(f"[wide] rank {r}: build {g['build_s']:.2f} s, steps "
              + ", ".join(f"{k} {[round(t, 3) for t in v]}"
                          for k, v in m["s"].items())
              + ", collectives " + ", ".join(
                  f"{k} {[round(t, 3) for t in v]}"
                  for k, v in m["collective_s"].items()), flush=True)
    with open(os.path.join(out_dir, "prof0.txt")) as fh:
        print(fh.read()[:6000], flush=True)
    rec["failed"] = failed
    return rec


def diagnose(cs, dev, refine: float) -> dict:
    """What the sweep at ``refine`` rests on: its convergence signal
    (``diagnoseSweep``), the band basis's modes, the two-grid cycle's
    contraction as a stationary iteration on random right-hand sides
    (against the f64 band operator), the f32 coarse inverse against the
    coarse Galerkin operator, that operator against P^T K P through the
    rectangular band, and K3's one-lane panel products."""
    import numpy as np
    import torch

    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck
    from plate_inverse_problem_tpu_torch.ops.band import (
        band_mv, flat_to_band, rect_band_mv, rect_band_tmv)
    from plate_inverse_problem_tpu_torch.ops.dense import inv_refined
    from plate_inverse_problem_tpu_torch.ops.mg import twogrid_apply

    freqs = np.linspace(40.0, 600.0, cs.N_FREQ)
    p, _ = cs.construct(dev, refine, f"sh_i refine={refine:g}", "[diag]")
    core, od = p.getFRCore()
    lay, rl = p._band_layout, p._mg_rl
    print(f"[diag] n={p.n_free} rect band: hw={rl.hw} nd={rl.nd} bc={rl.bc}"
          f" n_c={rl.n_coarse} lmax={p._mg_lmax:.4g}; band basis modes "
          "(Hz): " + ", ".join(f"{f:.1f}" for f in np.sqrt(np.abs(
              p._band_lam)) / (2 * np.pi)), flush=True)
    d = p.diagnoseSweep(freqs)
    q = d["residual_norm"] / d["target"]
    print(f"[diag] diagnoseSweep: {int((~d['converged']).sum())} of "
          f"{freqs.size} lanes unconverged, rn / target min {q.min():.2e} "
          f"median {np.median(q):.2e} max {q.max():.2e}", flush=True)
    K64 = flat_to_band(od["Kref64"], lay, od["band_lin"])
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, p.n_free, generator=g, device=dev,
                    dtype=torch.float64)

    def cycle(r):
        return twogrid_apply(p._band_pack, od["mg_dinv"], p._mg_lmax,
                             od["mg_Pt"], od["mg_Kcinv"],
                             r.to(torch.float32), lay, rl,
                             od["mg_slots"]).to(torch.float64)

    def stationary(Kc_inv):
        def cycle(r):
            return twogrid_apply(p._band_pack, od["mg_dinv"], p._mg_lmax,
                                 od["mg_Pt"], Kc_inv, r.to(torch.float32),
                                 lay, rl, od["mg_slots"]).to(torch.float64)

        e = torch.zeros_like(x)
        out = []
        for _ in range(6):
            r = x - band_mv(K64, e, lay)
            out.append(float(r.norm() / x.norm()))
            e = e + cycle(r)
        return out

    ratios = stationary(od["mg_Kcinv"])
    print("[diag] two-grid stationary iteration, |r_k| / |b|: " + ", ".join(
        f"{v:.3e}" for v in ratios), flush=True)
    # the same cycle with the coarse inverse in f64 (device inv_refined of
    # the host Kc), and the sweep on it
    Kc_d = torch.as_tensor(p._mg_Kc.toarray(), device=dev)
    Kc_inv64 = inv_refined(Kc_d)
    del Kc_d
    ratios64 = stationary(Kc_inv64)
    print("[diag] the same with an f64 coarse inverse: " + ", ".join(
        f"{v:.3e}" for v in ratios64), flush=True)
    kc32 = od["mg_Kcinv"]
    od["mg_Kcinv"] = Kc_inv64
    d64 = p.diagnoseSweep(freqs)
    q64 = d64["residual_norm"] / d64["target"]
    idx = [3, 256]
    from plate_inverse_problem_tpu_torch.oracle import splu_frf
    ref = splu_frf(p, freqs[idx])
    err64 = np.abs(d64["fr"][idx] - ref) / np.abs(ref)
    err32 = np.abs(d["fr"][idx] - ref) / np.abs(ref)
    print(f"[diag] sweep with the f64 coarse inverse: "
          f"{int((~d64['converged']).sum())} of {freqs.size} lanes "
          f"unconverged, rn / target max {q64.max():.2e}; rel err vs the "
          f"refined splu at {freqs[idx].round(2).tolist()} Hz: f64 "
          f"{err64.tolist()}, f32 {err32.tolist()}", flush=True)
    od["mg_Kcinv"] = kc32
    del Kc_inv64
    # the coarse inverse against the coarse operator (host f64)
    Kc = p._mg_Kc
    Xc = od["mg_Kcinv"][:, :256].double().cpu().numpy()
    E = Kc @ Xc
    E[np.arange(256), np.arange(256)] -= 1.0
    print(f"[diag] |Kc Kc_inv(f32)[:, :256] - I|_max = {np.abs(E).max():.3e}",
          flush=True)
    # P^T K P through the rectangular band against the host Kc (x in the
    # coarse ordering of perm_c: the compact slots)
    xc = torch.randn(2, rl.n_coarse, generator=g, device=dev,
                     dtype=torch.float32)
    y = rect_band_tmv(od["mg_Pt"], band_mv(K64, rect_band_mv(
        od["mg_Pt"], xc, rl, od["mg_slots"]).double(), lay).float(), rl,
        od["mg_slots"])
    ref = (Kc @ xc.double().cpu().numpy().T).T
    rel = float(np.abs(y.double().cpu().numpy() - ref).max()
                / np.abs(ref).max())
    print(f"[diag] P^T K P x (rect band, f32 P) vs Kc x: max rel {rel:.3e}",
          flush=True)
    csr = ck.build_csr(od["rows"], od["cols"], p.n_free)
    cs.compare_csr(csr, 32, 1, "f64", f"n={p.n_free} S=32 L=1 (panels)",
                   7, ones=True, tag="[diag]")
    out = {"ratios": ratios, "ratios64": ratios64,
           "err64": err64.tolist(), "err32": err32.tolist(),
           "kc_err": float(np.abs(E).max()),
           "galerkin_rel": rel, "rn_over_target_max": float(q.max())}
    del p, core, od
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--diagnose", default=None, metavar="REFINES",
                    help="comma-separated refine levels, e.g. 6,9")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slice17_probe: no CUDA device.")
    dev = torch.device("cuda")
    card = cs.card_info()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(band_kernel.build),
                  pool.submit(csr_kernel.build)]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    out = {"card": card}
    if args.diagnose is not None:
        out["diagnose"] = {r: diagnose(cs, dev, float(r))
                           for r in args.diagnose.split(",")}
        failed = []
    elif args.wide:
        out["wide"] = wide(cs, dev)
        failed = out["wide"]["failed"]
    else:
        kept = {}
        t0 = time.perf_counter()
        cs.per_modulus(dev, kept)
        freqs = np.linspace(40.0, 600.0, cs.N_FREQ)
        kept["d4_fwd"] = cs.fwd_d4(freqs, kept["d4"]).pop("rj")
        print(f"[time] phases 8 (b) and 10 (b) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        failed = []
        t0 = time.perf_counter()
        try:
            out["slice17"] = {k: v for k, v in cs.slice17(dev, kept).items()}
        except AssertionError as err:
            failed.append(str(err))
        print(f"[time] phase 15 in {time.perf_counter() - t0:.1f} s",
              flush=True)
    with open(os.path.join(OUT, "slice17.json"), "w") as f:
        json.dump(out, f, default=str)
    if failed:
        print("FAILED: " + " | ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
