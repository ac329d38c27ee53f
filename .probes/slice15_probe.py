"""The dof axis's partition of the two-grid and the band basis on one card,
without the rest of ``chip_smoke.py``: builds the two kernels as phase 2
does, prints the card's name and power limit, holds K1's window packs
against their plain version and the whole launch on the 21k plate's band
(``chip_smoke.compare_windows``), times the dense apply by fixed row
blocks against one DGEMM at n = 1466 and 11910 (``chip_smoke.k5_blocked``)
and runs ``chip_smoke.slice12`` (phase 14, (f) included) with the 21k
Problem for its oracle.  Writes the record to ``build/slice15/
slice15.json``; exits 1 if a check fails.

With ``--nccl`` (on a machine with several cards) it runs only the
dof paths over NCCL, a rank a card as (freq 1, dof W): phase 14 (e)'s
11910-DOF dense-tier plate and (f)'s 20916-DOF two-grid plate, each
rank's FRF against the unsharded sweep it ran before placement (the
bits), its memory at placement and its steps' times.

Run from the repository root:  python3 .probes/slice15_probe.py
[--parts abcdf] [--skip-k5] [--nccl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="abcdf")
    ap.add_argument("--skip-k5", action="store_true")
    ap.add_argument("--nccl", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slice15_probe: no CUDA device.")
    dev = torch.device("cuda")
    print(cs.card_info(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(band_kernel.build),
                  pool.submit(csr_kernel.build)]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    out = {"card": cs.card_info()}
    if args.nccl:
        return nccl_dof(cs, out)
    p21 = cs.sh_i_problem(dev, 4.0)
    od = p21.getFRCore()[1]
    lay = p21._band_layout
    chunk = p21._auto_freq_chunk() or cs.N_FREQ
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2 * chunk, p21.n_free)).astype(np.float32), device=dev)
    out["windows"] = cs.compare_windows(p21._band_pack, od["mg_band0"], x,
                                        lay)
    if not args.skip_k5:
        for refine, label in ((1.0, "bench"), (3.0, "n=11910")):
            p = cs.sh_i_problem(dev, refine)
            p.getFRCore()
            out[f"k5_{p.n_free}"] = cs.k5_blocked(p, label)
            del p
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["slice12"] = cs.slice12(dev, args.parts, p21=p21)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[time] phase 14 in {out['phase_s']:.1f} s", flush=True)
    os.makedirs(os.path.join(ROOT, "build", "slice15"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "slice15", "slice15.json"),
              "w") as fh:
        json.dump(out, fh, default=float, indent=1)
    return 0


def nccl_dof(cs, out) -> int:
    """(e) and (f) over NCCL as (freq 1, dof W), against the unsharded
    sweep each rank runs before its mesh places the Problem."""
    import torch

    from plate_inverse_problem_tpu_torch.parallel import ranks

    world = torch.cuda.device_count()
    specs = {"e": ({"geometry": "sh_i", "refine": 3.0}, cs.N_FREQ, ()),
             "f": ({"geometry": "sh_i", "refine": 4.0}, cs.DOF_TG_FREQ,
                   ("gn_adjoint",))}
    failed = []
    for key, (plate, points, steps) in specs.items():
        d = os.path.join(ROOT, "build", "slice15", f"{key}_nccl")
        os.makedirs(d, exist_ok=True)
        spec = {"plate": plate, "meshes": [(1, world)],
                "freqs": (40.0, 600.0, points), "theta": cs.SHARD_THETA,
                "repeats": 2, "steps": steps, "at_theta": True,
                "reference": True}
        t0 = time.perf_counter()
        ranks.spawn(ranks.sharded_checks, world, d, spec, device="cuda")
        recs = ranks.load(d, world)
        ms = [r["meshes"][0] for r in recs]
        label = f"({key}) NCCL dof {world}"
        print(f"[slice15] {label}: n={recs[0]['n_free']}, {points} points, "
              f"{time.perf_counter() - t0:.1f} s with the spawn (build "
              f"{recs[0]['build_s']:.2f} s)", flush=True)
        mem = cs.shard_memory(label, recs)
        cs.owned_rows(label, ms, mem, failed)
        rep = cs.shard_report(label, ms, ("frf",) + steps + tuple(
            "ref_" + k for k in ("frf",) + steps))
        bits = cs.dof_bits(label, ms, ms[0]["ref_frf"][0],
                           "the unsharded sweep", failed)
        if steps:
            cs.shard_close(f"{label} GN adjoint update vs the single-"
                           "process step", ms[0]["gn_adjoint"][0][1],
                           ms[0]["ref_gn_adjoint"][0][1], cs.SHARD_TOL,
                           failed)
        out[key] = {"memory": mem, "steps": rep, "bits": bits,
                    "shards": [m["shards"] for m in ms]}
    os.makedirs(os.path.join(ROOT, "build", "slice15"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "slice15", "nccl.json"),
              "w") as fh:
        json.dump(out, fh, default=float, indent=1)
    if failed:
        print("[slice15] failed: " + " | ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
