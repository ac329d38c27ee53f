"""The FGMRES cycle's Givens least squares in CUDA (K7a ``givens_step``,
K7b ``backsub``) against the tree before it, on one NVIDIA GPU.

For each tree named, in the order given (parent, change, change, parent
compares two trees in turns): the bench plate (``sh_i`` refine = 1, n =
1466: flat + dense) and the 21k plate (refine = 4, n = 20916: band +
two-grid), isotropic steel, AP1030, 512 points over 40-600 Hz, each in a
process of its own (one profiler capture a process): a first and three
steady synchronised sweeps through ``Problem.solveForward``, then one
steady sweep of the core under ``diagnostics.profile.profile_call`` (as
``chip_smoke.py`` phase 13 (e) traces it): the kernels in its Chrome
trace, the device's busy time and share of the traced call, and the
kernels by kind (K7 on its own line).  Prints one line a run and writes
each run's record to ``--out`` (default ``build/slice18/``); the traces
go to ``build/slice18/``.

``--phase16`` then runs ``chip_smoke.py``'s phase 16 alone on this tree
(the 21k Problem, phase 13 (e)'s trace of a bench sweep and phase 6 / 7
(b)'s inverse halves first, as the smoke runs them).  ``--k3-104k``
times K3 on the refine-9 pattern (n = 103680) at the residual map's 24
folded tangents and 1024 lanes (2.55e9 outputs) beside its plain version
(the ``index_add_`` scatter by nnz segments) and one ``torch.sparse.mm``
(the library call, ``chip_smoke.py``'s yardstick), by CUDA events, with
its bound.

Run from the repository root, the parent's tree unpacked beside it:

    mkdir -p build/parent18 && git archive 99b81ff | tar -x -C build/parent18
    python3 .probes/slice18_probe.py build/parent18 . --order 0,1,1,0
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
KINDS = [("K7 fgmres_lsq", ("givens_step_kernel", "backsub_kernel")),
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


def one(tree: str, plate: str, tag: str) -> dict:
    """One plate on one tree, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.diagnostics import profile
    from plate_inverse_problem_tpu_torch.ops import band_kernel, csr_kernel

    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"imported {pt.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("slice18_probe: no CUDA device")
    builds = [band_kernel.build, csr_kernel.build]
    try:
        from plate_inverse_problem_tpu_torch.ops import fgmres_kernel
        builds.append(fgmres_kernel.build)
    except ImportError:            # the tree before K7
        fgmres_kernel = None
    for build in builds:
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
        p.solveForward(freqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    core, od = p.getFRCore()
    f_t = torch.as_tensor(freqs, device=dev)
    th = torch.as_tensor(np.asarray(p.parameters, np.float64), device=dev)
    if fgmres_kernel is not None:
        fgmres_kernel.reset_launches()
    logdir = os.path.join(ROOT, "build", "slice18", tag)
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rec = {"tree": tag, "plate": plate, "n_free": p.n_free, "card": card,
           "sweep_first_s": times[0], "sweep_steady_s": times[1:],
           "traced_wall_s": wall, "kernels_in_trace": len(kernels),
           "device_busy_ms": busy_ms, "busy_share": busy_ms / (1e3 * wall),
           "by_kind": by_kind, "trace": os.path.relpath(run, ROOT)}
    if fgmres_kernel is not None:
        rec["k7_counted"] = {"givens_step":
                             fgmres_kernel.givens_step_cuda.launches,
                             "backsub": fgmres_kernel.backsub_cuda.launches}
    return rec


def k3_104k(S: int = 24, L: int = 1024) -> dict:
    """K3, its plain version and the library call at the 104k folded
    tangents' shape (PERF.md's K3 table)."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    ck.build()
    dev = torch.device("cuda")
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=9.0)
    p = pt.Problem(geom, mat, acc, device=dev)       # assembly only
    pat = p.op.pattern
    csr = ck.build_csr(torch.as_tensor(pat.rows, device=dev),
                       torch.as_tensor(pat.cols, device=dev), p.n_free)
    rng = np.random.default_rng(16)
    data = torch.as_tensor(rng.standard_normal((S, csr.nnz)), device=dev)
    x = torch.as_tensor(rng.standard_normal((L, csr.n)), device=dev)
    rec = {"n": csr.n, "nnz": csr.nnz, "S": S, "L": L,
           "outputs": S * L * csr.n}
    rec["ms"] = cs.time_ms(lambda: ck.csr_mv_cuda(data, x, csr), reps=3)[0]
    torch.cuda.empty_cache()
    seg = max(1024, min(csr.nnz, 2**31 // (S * L * 8)))
    rec["plain_ms"] = cs.cuda_event_ms(
        lambda: ck.csr_mv_reference(data, x, csr, seg), reps=2)
    torch.cuda.empty_cache()
    d = (data if csr.perm is None else data[:, csr.perm]).reshape(-1)
    crow = torch.cat([csr.rowptr[:-1].long() + s * csr.nnz for s in range(S)]
                     + [torch.tensor([S * csr.nnz], device=dev)])
    A = torch.sparse_csr_tensor(crow, csr.col.long().repeat(S), d,
                                size=(S * csr.n, csr.n))
    xt = x.t().contiguous()
    rec["library_ms"] = cs.cuda_event_ms(lambda: torch.sparse.mm(A, xt),
                                         reps=3)
    rec["bound_ms"], rec["bound_by"] = cs.csr_bound_ms(csr, S, L, 8)
    rec["card"] = cs.card_info()
    print(f"[k3 104k] S={S} L={L} n={csr.n} ({rec['outputs']} outputs): "
          f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
          f"library (torch.sparse.mm) {rec['library_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}); {rec['card']}",
          flush=True)
    return rec


def phase16() -> dict:
    """chip_smoke.py's phase 16 alone, with what it reads from phases 6,
    7 (b) and 13 (e) run first on fresh Problems."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import (band_kernel, csr_kernel,
                                                     fgmres_kernel)

    for build in (band_kernel.build, csr_kernel.build, fgmres_kernel.build):
        build()
    dev = torch.device("cuda")
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    p21 = cs.sh_i_problem(dev, 4.0)
    bench = cs.sh_i_problem(dev, 1.0)
    inv21 = cs.inverse_half(p21, freqs, p21.solveForward(freqs).cpu().numpy(),
                            grad_tol=cs.GRAD_TOL_21K)
    inv_bench = cs.inverse_half(bench, freqs,
                                bench.solveForward(freqs).cpu().numpy(),
                                k1=False, tag="[dense] (b) ")
    trace = cs.traced_sweep(bench, freqs)
    t0 = time.perf_counter()
    out = cs.slice18(dev, p21, trace, inv21, inv_bench)
    out["phase_16_s"] = time.perf_counter() - t0
    print(f"[time] phase 16 in {out['phase_16_s']:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="trees to compare (their roots)")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices into the trees, the order "
                         "of the runs (default: each once)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "slice18"),
                    help="directory of the records (default build/slice18)")
    ap.add_argument("--one", nargs=3, metavar=("TREE", "PLATE", "TAG"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--phase16", action="store_true",
                    help="then run chip_smoke.py's phase 16 alone")
    ap.add_argument("--k3-104k", action="store_true",
                    help="then time K3, its plain version and the library "
                         "call at the 104k folded tangents' shape")
    args = ap.parse_args()
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    if args.one:
        rec = one(*args.one)
        print(json.dumps(rec), flush=True)
        return 0
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(args.trees))))
    runs = []
    for step, i in enumerate(order):
        tag = f"{step}_{os.path.basename(os.path.abspath(args.trees[i]))}"
        for plate in REFINE:
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
            kinds = ", ".join(f"{k} {n} ({ms:.2f} ms)" for k, (n, ms) in
                              sorted(rec["by_kind"].items(),
                                     key=lambda kv: -kv[1][1]))
            print(f"[slice18] {tag} {plate} (n = {rec['n_free']}, "
                  f"{rec['card']}): first {rec['sweep_first_s']:.4f} s, "
                  "steady " + ", ".join(f"{t:.4f}" for t in
                                        rec["sweep_steady_s"])
                  + f" s; traced {rec['traced_wall_s']:.4f} s, "
                  f"{rec['kernels_in_trace']} kernels, busy "
                  f"{rec['device_busy_ms']:.2f} ms "
                  f"({100 * rec['busy_share']:.1f} %); "
                  f"K7 counted {rec.get('k7_counted')}; by kind: {kinds}",
                  flush=True)
    for flag, fn, name in ((args.phase16, phase16, "phase16"),
                           (args.k3_104k, k3_104k, "k3_104k")):
        if flag:
            rec = fn()
            with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
                json.dump(rec, fh)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
