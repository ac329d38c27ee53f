"""The FGMRES cycle's Givens least squares (K7a ``givens_step``, K7b
``backsub``, ``csrc/fgmres_lsq.cu``) against the tree before it, on one
NVIDIA GPU: the kernels' device and host times at the same calls, and the
sweeps they run in.

For each tree named, in the order given (parent, change, change, parent
compares two trees in turns), the bench plate (``sh_i`` refine = 1, n =
1466: flat + dense) and the 21k plate (refine = 4, n = 20916: band +
two-grid), isotropic steel, AP1030, 512 points over 40-600 Hz, each in a
process of its own (one profiler capture a process):

* a first and three steady synchronised sweeps through
  ``Problem.solveForward``, then one more with every K7a / K7b call
  recorded through the names ``_pgmres_cycle`` calls;
* the first recorded K7a and K7b call timed as ``chip_smoke.py`` phase 16
  (b) times it (``time_ms``: 100 launches behind a device sleep, CUDA
  events for the device, the host clock for the wrapper's enqueue), and
  ``torch.linalg.solve_triangular`` on K7b's complex R and masked g (the
  library's yardstick);
* whole synthetic cycles (``fgmres_kernel.synthetic_cycle`` at the plate's
  first-call lanes, k = 8; the bench process also k = 16 and 64 at 512
  lanes): 20 fresh copies of a cycle's state, each run through its k
  steps and its back-substitution, timed the same way: device and host ms
  a call as the main path pays them (the state checked once a cycle);
* one steady sweep of the core under ``diagnostics.profile.profile_call``
  (as ``chip_smoke.py`` phase 13 (e) traces it): the kernels in its Chrome
  trace, the device's busy time and share, the kernels by kind, K7's
  kernels, ms and share of the busy time on their own line.

Prints one line a run and writes each run's record to ``--out`` (default
``build/slice19/``), the traces beside them.  ``--phase16`` then runs
``chip_smoke.py``'s phase 16 alone on this tree (``slice18_probe.py``'s).

Run from the repository root, the parent's tree unpacked beside it:

    mkdir -p build/parent19 && git archive fe0cd89 | tar -x -C build/parent19
    python3 .probes/slice19_probe.py build/parent19 . --order 0,1,1,0
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FREQ = 512
REFINE = {"bench": 1.0, "21k": 4.0}
SLEEP_CYCLES = 20_000_000      # ~10 ms of device sleep ahead of a timed run
K7 = ("givens_step_kernel", "backsub_kernel")
KINDS = [("K7 fgmres_lsq", K7),
         ("K3 csr_mv", ("csr_mv_",)),
         ("K1 band_mv", ("band_mv",)),
         ("gemm", ("gemm", "gemv", "cutlass", "dot_kernel")),
         ("index/scatter/gather", ("index", "scatter", "gather")),
         ("transpose/copy", ("copy", "Copy", "transpose")),
         ("cat/stack", ("cat", "Cat")),
         ("reduce", ("reduce", "Reduce")),
         ("elementwise", ("elementwise", "Elementwise", "vectorized"))]


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def time_ms(fn, reps: int = 100) -> tuple[float, float]:
    """(device ms, host ms) a call of ``fn``, after a warm-up: a device
    sleep queued first lets the host enqueue every call before the first
    runs (``chip_smoke.time_ms``)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def call_times(fk, name: str, args) -> dict:
    """One recorded K7a / K7b call's device and host ms (``time_ms`` on a
    copy of its arguments), and for K7b the library's."""
    import torch

    a = [x.clone() if torch.is_tensor(x) else x for x in args]
    kernel = fk.givens_step_cuda if name == "givens_step" else fk.backsub_cuda
    ms, host_ms = time_ms(lambda: kernel(*a))
    k = (args[3] if name == "givens_step" else args[0]).shape[1]
    rec = {"L": int(args[0].shape[0]), "k": int(k), "ms": ms,
           "host_ms": host_ms, "library_ms": None,
           "bucket": fk.bucket(k) if hasattr(fk, "bucket") else None}
    if name == "backsub":
        R, g, j_fin = a
        rows_on = torch.arange(k, device=R.device)[None, :] < j_fin[:, None]
        g_c = torch.view_as_complex(
            torch.where(rows_on[..., None], g[:, :k], 0.0).contiguous())
        R_c = torch.view_as_complex(R)
        rec["library_ms"] = time_ms(lambda: torch.linalg.solve_triangular(
            R_c, g_c[..., None], upper=True))[0]
    return rec


def cycle_times(fk, L: int, k: int, copies: int = 20) -> dict:
    """Device and host ms a K7 call over ``copies`` whole synthetic cycles
    (k steps and a back-substitution each), every cycle on a fresh copy of
    the state, as ``_pgmres_cycle`` runs them."""
    import torch

    dev = torch.device("cuda")
    state, steps, _, _, j_fin = fk.synthetic_cycle(L, k, seed=k, device=dev)
    jf = torch.as_tensor(j_fin, device=dev)
    keys = fk.STATE_KEYS

    def run(st):
        for j, s in enumerate(steps):
            fk.givens_step_cuda(s["hre"], s["him"], s["hlast"],
                                *(st[key] for key in keys), s["active"], j,
                                j == 0)
        fk.backsub_cuda(st["R"], st["g"], jf)

    run({key: v.clone() for key, v in state.items()})       # warm
    copies_ = [{key: v.clone() for key, v in state.items()}
               for _ in range(copies)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for st in copies_:
        run(st)
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    n = copies * (k + 1)
    return {"L": L, "k": k, "calls": n, "ms": start.elapsed_time(end) / n,
            "host_ms": 1e3 * host / n}


def one(tree: str, plate: str, tag: str) -> dict:
    """One plate on one tree, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.diagnostics import profile
    from plate_inverse_problem_tpu_torch.ops import (band_kernel, csr_kernel,
                                                     fgmres_kernel, mixed)

    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"imported {pt.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("slice19_probe: no CUDA device")
    for build in (band_kernel.build, csr_kernel.build, fgmres_kernel.build):
        build()
    dev = torch.device("cuda")
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=REFINE[plate])
    p = pt.Problem(geom, mat, acc, device=dev)
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = p.solveForward(freqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    checksum = (float(np.abs(fr.cpu().numpy()).sum()) if plate == "bench"
                else None)

    # every K7 call of one more steady sweep, through the names
    # _pgmres_cycle calls
    calls, saved = [], (mixed.givens_step, mixed.backsub)

    def recorder(name, fn):
        def call(*args):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)))
            return fn(*args)
        return call

    mixed.givens_step = recorder("givens_step", saved[0])
    mixed.backsub = recorder("backsub", saved[1])
    try:
        p.solveForward(freqs)
    finally:
        mixed.givens_step, mixed.backsub = saved
    torch.cuda.synchronize()
    first = {name: call_times(fgmres_kernel, name,
                              next(a for n, a in calls if n == name))
             for name in ("givens_step", "backsub")}
    L0 = first["givens_step"]["L"]
    cycles = [cycle_times(fgmres_kernel, L0, 8)]
    if plate == "bench":
        cycles += [cycle_times(fgmres_kernel, 512, k) for k in (16, 64)]
    del calls
    torch.cuda.empty_cache()

    core, od = p.getFRCore()
    f_t = torch.as_tensor(freqs, device=dev)
    th = torch.as_tensor(np.asarray(p.parameters, np.float64), device=dev)
    fgmres_kernel.reset_launches()
    logdir = os.path.join(ROOT, "build", "slice19", tag)
    _, run, wall = profile.profile_call(core, f_t, th, od, label=plate,
                                        logdir=logdir, warmup=False)
    with open(os.path.join(run, profile.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    by_kind = {}
    for e in kernels:
        n, ms = by_kind.get(kind_of(e.get("name", "")), (0, 0.0))
        by_kind[kind_of(e.get("name", ""))] = (n + 1, ms + e["dur"] / 1e3)
    k7_n, k7_ms = by_kind.get("K7 fgmres_lsq", (0, 0.0))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    return {"tree": tag, "plate": plate, "n_free": p.n_free, "card": card,
            "sweep_first_s": times[0], "sweep_steady_s": times[1:],
            "checksum": checksum, "first_calls": first, "cycles": cycles,
            "traced_wall_s": wall, "kernels_in_trace": len(kernels),
            "device_busy_ms": busy_ms, "busy_share": busy_ms / (1e3 * wall),
            "k7_in_trace": k7_n, "k7_ms": k7_ms,
            "k7_share_of_busy": k7_ms / busy_ms if busy_ms else None,
            "k7_counted": {"givens_step":
                           fgmres_kernel.givens_step_cuda.launches,
                           "backsub": fgmres_kernel.backsub_cuda.launches},
            "by_kind": by_kind, "trace": os.path.relpath(run, ROOT)}


def phase16() -> dict:
    """``chip_smoke.py``'s phase 16 alone (``slice18_probe.phase16``)."""
    sys.path.insert(0, os.path.join(ROOT, ".probes"))
    import slice18_probe

    return slice18_probe.phase16()


def report(rec: dict) -> str:
    f = rec["first_calls"]
    calls = "; ".join(
        f"{n} L={r['L']} k={r['k']} bucket {r['bucket']}: {r['ms']:.4f} ms "
        f"device, {r['host_ms']:.4f} ms host"
        + (f", solve_triangular {r['library_ms']:.4f} ms"
           if r["library_ms"] is not None else "")
        for n, r in f.items())
    cycles = "; ".join(f"L={c['L']} k={c['k']}: {c['ms']:.4f} / "
                       f"{c['host_ms']:.4f} ms" for c in rec["cycles"])
    kinds = ", ".join(f"{k} {n} ({ms:.2f} ms)" for k, (n, ms) in
                      sorted(rec["by_kind"].items(), key=lambda kv: -kv[1][1]))
    return (f"[slice19] {rec['tree']} {rec['plate']} (n = {rec['n_free']}, "
            f"{rec['card']}): first {rec['sweep_first_s']:.4f} s, steady "
            + ", ".join(f"{t:.4f}" for t in rec["sweep_steady_s"])
            + (f" s, checksum {rec['checksum']!r}" if rec["checksum"]
               else " s")
            + f"; first calls: {calls}; whole cycles (device / host ms a "
            f"call): {cycles}; traced {rec['traced_wall_s']:.4f} s, "
            f"{rec['kernels_in_trace']} kernels, busy "
            f"{rec['device_busy_ms']:.2f} ms "
            f"({100 * rec['busy_share']:.1f} %), K7 {rec['k7_in_trace']} "
            f"kernels {rec['k7_ms']:.3f} ms "
            f"({100 * (rec['k7_share_of_busy'] or 0):.2f} % of busy), "
            f"counted {rec['k7_counted']}; by kind: {kinds}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="trees to compare (their roots)")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices into the trees, the order "
                         "of the runs (default: each once)")
    ap.add_argument("--plates", default=",".join(REFINE),
                    help="comma-separated plates to run (default: "
                         "bench,21k)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "slice19"),
                    help="directory of the records (default build/slice19)")
    ap.add_argument("--one", nargs=3, metavar=("TREE", "PLATE", "TAG"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--phase16", action="store_true",
                    help="then run chip_smoke.py's phase 16 alone")
    args = ap.parse_args()
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    if args.one:
        print(json.dumps(one(*args.one)), flush=True)
        return 0
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(args.trees))))
    runs = []
    for step, i in enumerate(order):
        tag = f"{step}_{os.path.basename(os.path.abspath(args.trees[i]))}"
        for plate in args.plates.split(","):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 args.trees[i], plate, tag], capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
                raise RuntimeError(f"run {tag} {plate} failed")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append(rec)
            with open(os.path.join(out_dir, f"{tag}_{plate}.json"), "w") as fh:
                json.dump(rec, fh)
            print(report(rec), flush=True)
    if args.phase16:
        rec = phase16()
        with open(os.path.join(out_dir, "phase16.json"), "w") as fh:
            json.dump(rec, fh)
    print(json.dumps({"runs": len(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
