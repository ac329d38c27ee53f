"""Where the time goes in the PyTorch port's 21k-DOF band-tier sweep (one GPU).

Builds the slice that chip_smoke.py drives (sh_i strip, refine = 4,
isotropic steel, AP1030, 512 frequencies over 40-600 Hz) on ``cuda`` and:

1. runs a first sweep, then three timed steady sweeps (wall seconds,
   synchronised);
2. runs one more steady sweep under ``torch.profiler`` with counting
   wrappers around the sweep's layers: FGMRES chunks and cycles, two-grid
   cycles (preconditioner applies = cycles / 2), f64 band applies, K1
   launches and a histogram of their lane counts B; and reports the device
   time (sum of the CUDA kernels' self time), the device time by kernel
   kind, the idle share of the mean steady sweep, and the count and host
   time of ``cudaLaunchKernel``;
3. builds two more Problems (two more ARPACK start vectors, so two more
   band bases) and, for all three, the worst relative FRF error against
   the host f64 splu oracle at 4 points including the |FRF| peak;
4. with ``--k1-floors``: what sets K1's time.  It builds three variants of
   ``csrc/band_mv.cu`` by editing its text (no FMAs; no FMAs and the x
   slices of only the first half of the lanes; no FMAs and no x slices;
   their results are wrong on purpose) and times them beside K1 at the
   slice shape, B = 128, 16 and 2, in turns.

``--tile-count`` instead counts, on the host and without a GPU, how the
slice's f32 K_ref band splits into tiles of several shapes (the count
behind K1's 16 x 8 tile): tiles holding a nonzero, packed MB, FLOP at
B = 128 and the x slices pulled per apply.

``--gn`` instead profiles the inverse half at the slice: the adjoint
Gauss-Newton residual and Jacobian (``ResidualFunction("log_afc")
.value_and_jac``) at theta_0 = truth x (1.05, 1.02, 1.2) against the FRF
at the truth.  One first and three timed steady calls, then one steady
call under ``torch.profiler`` with timing wrappers (synchronised) around
the primal sweep, the adjoint sweep and the residual-map tangents: device
busy vs wall and the idle share, kernel launches, the wall time of each
part, K1 launches by lane count B in each sweep, and the device time by
kernel kind.

``--dense`` instead profiles the dense-preconditioner tier at its two
plates: ``sh_i`` refine = 1 (n = 1466, the bench configuration, flat
layout) and refine = 3 (n = 11910, band layout), both at "auto".  For
each: construction (and the dense f64 inverse's build), a first and three
timed steady sweeps, one steady sweep under ``torch.profiler`` with
counting wrappers (FGMRES chunks and cycles, K5 products by row count,
K3 fused f64 flat applies, flat SpMVs, f64 band applies, K1 launches,
which must be 0), the device busy time and idle share, and the device
time by kernel kind; then K3 and K5 alone at the slice shape (512 lanes,
re/im: 1024 rows), timed with CUDA events beside their bounds and, for K3,
the library call (``torch.sparse.mm`` on CSR K and M).

``--fd-cpu`` instead runs on the CPU at n = 1466 (``sh_i`` refine = 1,
``precond="mg", operator_layout="band"``): every column of the adjoint
Jacobian against a central difference of r at relative steps 1e-5 to
1e-2, at 64 and 512 points over 40-600 Hz — the numbers behind
chip_smoke.py's FD_STEPS and FD_TOL —
and ``solveInverse(..., "gn", N_steps=8)`` from the same start at 512
points, with every iterate.

Prints the JSON record as its last line and writes it, with the
profiler's kernel table, under ``--out`` (default build/profile/).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 .probes/torch_sweep_profile.py
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
sys.path.insert(0, ROOT)

N_FREQ = 512
KINDS = [("K1 band_mv_f32", ("band_mv_f32_kernel",)),
         ("gemm", ("gemm", "gemv", "cutlass", "dot_kernel")),
         ("index_add/scatter/gather", ("index", "scatter", "gather")),
         ("cat/stack", ("cat", "Cat")),
         ("reduce", ("reduce", "Reduce")),
         ("elementwise", ("elementwise", "Elementwise", "vectorized"))]


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def build(dev, construct: bool = True, refine: float = 4.0, **kw):
    import plate_inverse_problem_tpu_torch as pt

    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                       refine=refine)
    p = pt.Problem(geom, mat, acc, device=dev, **kw)
    if construct:
        p.getFRCore()
    return p


def worst_oracle_err(p, freqs, fr):
    from plate_inverse_problem_tpu_torch.oracle import splu_frf

    ipk = int(np.argmax(fr))
    idx = [3, ipk, freqs.size // 2, freqs.size - 1]
    ref = splu_frf(p, freqs[idx])
    rel = np.abs(fr[idx] - ref) / np.abs(ref)
    return float(rel.max()), float(freqs[idx[int(np.argmax(rel))]])


def count_calls(module, name, counts):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def record_lanes(module, hist_of):
    """Wrap ``module.band_mv_f32`` to count its calls by lane count B in
    the dict ``hist_of()`` returns."""
    fn = module.band_mv_f32

    def wrapped(pack, x, layout):
        B = x.numel() // layout.n
        hist = hist_of()
        hist[B] = hist.get(B, 0) + 1
        return fn(pack, x, layout)

    module.band_mv_f32 = wrapped
    return lambda: setattr(module, "band_mv_f32", fn)


# text edits of csrc/band_mv.cu for the K1 floors: each (old, new) must
# match the source exactly once
_NO_FMA = ("        const float* T = Ts[t % STAGES] + w * RPT * TK;",
           "        acc[0][0] += Ts[t % STAGES][tid] + Xs[t % STAGES][tid];\n"
           "        continue;\n"
           "        const float* T = Ts[t % STAGES] + w * RPT * TK;")
_X_LOOP = "            for (int e = tid; e < nl * (TK / 4); e += NT) {"
_HALF_X = (_X_LOOP, _X_LOOP.replace("nl * (TK / 4)", "(nl / 2) * (TK / 4)"))
_NO_X = (_X_LOOP, _X_LOOP.replace("nl * (TK / 4)", "0"))


def k1_floors(p, out_dir):
    """Device us of K1 and of its no-FMA / half-x / no-x variants at the
    slice shape, B = 128, 16 and 2, timed in turns (chip_smoke.time_ms)."""
    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel

    with open(band_kernel.SOURCE) as fh:
        src = fh.read()
    variants = {"no_fma": [_NO_FMA], "no_fma_half_x": [_NO_FMA, _HALF_X],
                "no_fma_no_x": [_NO_FMA, _NO_X]}
    runs = []
    os.makedirs(out_dir, exist_ok=True)
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit target not found once in "
                                   f"{band_kernel.SOURCE}: {old!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"k1_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        runs.append(cs.load_ab_kernel(path))
    pack, band, lay = p._band_pack, p.getFRCore()[1]["mg_band0"], \
        p._band_layout
    rng = np.random.default_rng(0)
    res = {}
    for B in (128, 16, 2):
        x = torch.as_tensor(rng.standard_normal((B, lay.n)),
                            dtype=torch.float32, device="cuda")
        fns = {"k1": lambda: band_kernel.band_mv_f32_cuda(pack, x, lay)}
        for name, run in runs:
            fns[name] = (lambda run=run: run(pack, band, x, lay))
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k].append(1e3 * cs.time_ms(fns[k])[0])
        res[B] = {k: float(np.mean(v)) for k, v in times.items()}
        print(f"[k1 floors] B={B}: " + "  ".join(
            f"{k} {v:.1f} us" for k, v in res[B].items()), flush=True)
    return res


def tile_count(B: int = 128):
    """Host count of the slice's f32 K_ref band (no GPU): for each tile
    shape, the tiles holding a nonzero, packed MB, tile-dense FLOP and x
    slices pulled at B lanes, tiles per row tile."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.band import (
        build_band_layout, flat_to_band)
    from plate_inverse_problem_tpu_torch.ops.band_kernel import (
        pack_band_tiles)

    p = build("cpu", construct=False)
    op = p.op
    lay = build_band_layout(op.pattern.rows, op.pattern.cols, op.n_free)
    band = flat_to_band(
        torch.as_tensor(p._reference_stiffness_flat(), dtype=torch.float32),
        lay, torch.as_tensor(lay.lin, dtype=torch.int64))
    nnz = int((pack_band_tiles(band, lay, (1, 1)).vals != 0).sum())
    print(f"[tiles] n={lay.n} b={lay.b} nb={lay.nb}: {nnz} numeric "
          f"nonzeros ({nnz / lay.n:.1f} a row)", flush=True)
    for tm, tk in ((32, 16), (16, 16), (16, 8), (8, 8), (32, 8), (64, 8)):
        pk = pack_band_tiles(band, lay, (tm, tk))
        t = pk.vals.shape[0]
        per = pk.row_ptr.diff().float()
        print(f"[tiles] {tm:2d} x {tk:2d}: {t:6d} tiles "
              f"({100 * t / (lay.nb * lay.b * 3 * lay.b / (tm * tk)):.1f} %), "
              f"{4e-6 * t * tm * tk:.1f} MB packed, "
              f"{2e-6 * t * tm * tk * B:.0f} MFLOP and "
              f"{4e-6 * t * tk * B:.1f} MB of x slices at B = {B}; "
              f"{per.mean():.1f} / {int(per.max())} tiles a row tile",
              flush=True)


START = np.array([1.05, 1.02, 1.2])


def profile_events(prof, wall_ms: float) -> dict:
    """Device busy (sum of the CUDA kernels' self time), the idle share of
    ``wall_ms``, device ms by kernel kind, the launch calls' count and host
    time, and the top kernels, from one ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    kernels, by_kind, launch = [], {}, {"count": 0, "host_ms": 0.0}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms = getattr(e, key) / 1e3
            kernels.append((ms, e.count, e.key))
            by_kind[kind_of(e.key)] = by_kind.get(kind_of(e.key), 0.0) + ms
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launch["count"] += e.count
            launch["host_ms"] += e.cpu_time_total / 1e3
    busy = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    return {"device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "kernel_launches": launch,
            "top_kernels": [{"ms": ms, "count": c, "name": nm[:120]}
                            for ms, c, nm in kernels[:12]],
            "_table": events.table(sort_by=key, row_limit=60)}


def gn_profile(args, card: str) -> dict:
    """--gn: where the time of one steady adjoint r + J goes at the slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plate_inverse_problem_tpu_torch.ops import band_kernel, mg, mixed

    dev = torch.device("cuda")
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    p = build(dev)
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    fr = p.solveForward(freqs).cpu().numpy()
    truth = np.asarray(p.parameters)
    th0 = truth * START
    rf = p.getResidualFunction(freqs, fr, kind="log_afc")

    def rj():
        out = rf.value_and_jac(th0)
        torch.cuda.synchronize()
        return out

    # what a process pays once for the first forward-mode vmap: a toy
    # jacfwd through the ops of the residual map (out-of-place index_add,
    # dot, gather), before the first r + J
    def toy(v):
        x = torch.arange(8.0, dtype=v.dtype, device=v.device)
        idx = torch.tensor([0, 1, 1, 2], device=v.device)
        b = torch.dot(v, v) / torch.dot(v, x[:3])
        out = torch.zeros(2, 3, dtype=v.dtype, device=v.device)
        return out.index_add(-1, idx[:3], (b * v * x[idx[1:]]).expand(2, 3))

    t0 = time.perf_counter()
    torch.func.jacfwd(toy)(torch.ones(3, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    rec["jacfwd_warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rj()
    rec["rj_first_s"] = time.perf_counter() - t0
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        rj()
        steady.append(time.perf_counter() - t0)
    rec["rj_steady_s"] = steady
    print(f"[gn] toy jacfwd first use {rec['jacfwd_warmup_s']:.3f} s; "
          f"r + J first {rec['rj_first_s']:.3f} s, steady "
          f"{', '.join(f'{s:.3f}' for s in steady)} s", flush=True)

    # one profiled steady r + J; the parts timed by synchronised wrappers,
    # K1 launches binned by lane count within each sweep
    core = p.getFRCore()[0]
    parts, lanes, phase = {}, {}, ["other"]

    def timed(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            phase[0] = name
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            phase[0] = "other"
            return out
        return run

    hooks = core.sweep_u, core.sweep_adj, core.apply_res
    core.sweep_u = timed("primal_sweep", hooks[0])
    core.sweep_adj = timed("adjoint_sweep", hooks[1])
    core.apply_res = timed("apply", hooks[2])
    undo = [record_lanes(m, lambda: lanes.setdefault(phase[0], {}))
            for m in (mg, mixed)]
    band_kernel.band_mv_f32_cuda.launches = 0
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rj()
            wall = time.perf_counter() - t0
    finally:
        core.sweep_u, core.sweep_adj, core.apply_res = hooks
        for u in undo:
            u()
    rec["profiled_wall_s"] = wall
    rec["part_wall_s"] = parts | {"rest": wall - sum(parts.values())}
    rec["k1_launches"] = band_kernel.band_mv_f32_cuda.launches
    rec["k1_launches_by_B"] = {k: dict(sorted(v.items()))
                               for k, v in lanes.items()}
    ev = profile_events(prof, float(np.mean(steady)) * 1e3)
    table = ev.pop("_table")
    rec.update(ev)
    print(f"[gn] profiled r + J {wall:.3f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in rec["part_wall_s"].items())
          + f"; device busy {ev['device_busy_ms']:.1f} ms of the "
          f"{ev['wall_ms']:.1f} ms mean steady r + J (idle "
          f"{100 * ev['idle_share']:.1f} %); {ev['kernel_launches']['count']}"
          f" kernel launches ({ev['kernel_launches']['host_ms']:.1f} ms host);"
          f" K1 launches {rec['k1_launches']} by sweep and B "
          f"{rec['k1_launches_by_B']}", flush=True)
    for kind, ms in ev["device_ms_by_kind"].items():
        print(f"[gn]   {kind:26s} {ms:9.3f} ms "
              f"({100 * ms / ev['device_busy_ms']:.1f} %)", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_gn_profile.txt"), "w") as fh:
        fh.write(table)
    return rec


def k3_k5_times(p, cs) -> dict:
    """K5 (the dense preconditioner's f64 GEMM) and K3 (the fused f64 flat
    K/M scatter apply) alone at the slice shape, B = 1024 rows, with their
    bounds (H100 SXM: 3.35 TB/s; 67 TFLOP/s f64 on the tensor cores for
    the DGEMM, 34 TFLOP/s f64 outside them for the scatter), and for K3 the
    library call: ``torch.sparse.mm`` of CSR K and M."""
    import torch

    from plate_inverse_problem_tpu_torch.ops import mixed

    od = p.getFRCore()[1]
    n, rows, cols = p.n_free, od["rows"], od["cols"]
    nnz = int(rows.numel())
    B, lanes = 1024, 512
    rng = np.random.default_rng(0)
    dev = rows.device
    x = torch.as_tensor(rng.standard_normal((B, n)), device=dev)
    uu = torch.as_tensor(rng.standard_normal((lanes, 2, n)), device=dev)
    # stiffness-like and mass data on the pattern (the values do not move
    # the times)
    KM = torch.stack([od["ABD"][2].sum(0), od["MIn"]])
    seg = mixed._flat_seg(nnz)
    Ks, Ms = (torch.sparse_coo_tensor(torch.stack([rows, cols]), v, (n, n))
              .coalesce().to_sparse_csr() for v in KM)
    u2 = uu.reshape(B, n).T.contiguous()
    inv = od["invK64"]
    fns = {
        "k5": lambda: mixed._dense_apply(inv, x),
        "k3_f64_fused": lambda: mixed._fused_apply_flat(KM, uu, rows, cols,
                                                        n, seg),
        "k3_library": lambda: (torch.sparse.mm(Ks, u2),
                               torch.sparse.mm(Ms, u2)),
    }
    ref = mixed._fused_apply_flat(KM, uu, rows, cols, n, seg)
    lib = torch.stack([m.T.reshape(lanes, 2, n)
                       for m in fns["k3_library"]()])
    lib_err = float((lib - ref).abs().max() / ref.abs().max())
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k].append(cs.time_ms(fns[k])[0])
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    bw, f64_tc, f64 = 3.35e12, 67e12, 34e12

    def bound(flop, nbytes, peak):
        t_b, t_o = nbytes / bw, flop / peak
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    k5 = bound(2.0 * B * n * n, 8.0 * n * n + 2 * 8.0 * B * n, f64_tc)
    # K3: S = 2 operators x nnz x B rows, one multiply-add each; data S x nnz
    # f64, rows and cols int64, x read once, S outputs written once
    k3 = bound(2.0 * 2 * nnz * B, 8.0 * 2 * nnz + 16.0 * nnz + 8.0 * B * n
               + 2 * 8.0 * B * n, f64)
    rec = {"n": n, "nnz": nnz, "B": B, "ms": ms,
           "k5_bound_ms": k5[0], "k5_bound_by": k5[1],
           "k3_bound_ms": k3[0], "k3_bound_by": k3[1],
           "k3_library_rel_err": lib_err}
    print(f"[dense] n={n} nnz={nnz} B={B}: K5 DGEMM {ms['k5']:.4f} ms (bound "
          f"{k5[0]:.4f} ms, {k5[1]}); K3 fused f64 K/M apply "
          f"{ms['k3_f64_fused']:.4f} ms (bound {k3[0]:.4f} ms, {k3[1]}; "
          f"library sparse.mm {ms['k3_library']:.4f} ms, rel {lib_err:.1e})",
          flush=True)
    return rec


def dense_profile(args, card: str) -> dict:
    """--dense: where the time of the dense tier's sweeps goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel, mixed

    dev = torch.device("cuda")
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    freqs = np.linspace(40.0, 600.0, N_FREQ)
    tables = []
    for refine in (1.0, 3.0):
        t0 = time.perf_counter()
        p = build(dev, refine=refine)
        torch.cuda.synchronize()
        r = {"ctor_s": time.perf_counter() - t0,
             "inv_build_s": p._inv_build_s, "n_free": p.n_free,
             "nnz": int(p.op.pattern.nnz), "tier": list(p._tier)}

        def sweep():
            y = p.solveForward(freqs)
            torch.cuda.synchronize()
            return y

        t0 = time.perf_counter()
        fr = sweep().cpu().numpy()
        r["sweep_first_s"] = time.perf_counter() - t0
        steady = []
        for _ in range(3):
            t0 = time.perf_counter()
            sweep()
            steady.append(time.perf_counter() - t0)
        r["sweep_steady_s"] = steady
        r["worst_rel_err"], r["worst_at_hz"] = worst_oracle_err(p, freqs, fr)

        counts, k5_lanes = {}, {}
        undo = [count_calls(mixed, nm, counts) for nm in
                ("_pgmres", "_pgmres_cycle", "_fused_apply_flat",
                 "spmv_flat", "band_mv")]
        k5 = mixed._dense_apply

        def k5_counted(inv, x32):
            rows = x32.numel() // inv.shape[0]
            k5_lanes[rows] = k5_lanes.get(rows, 0) + 1
            return k5(inv, x32)

        mixed._dense_apply = k5_counted
        undo.append(lambda: setattr(mixed, "_dense_apply", k5))
        band_kernel.band_mv_f32_cuda.launches = 0
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sweep()
        finally:
            for u in undo:
                u()
        r["counts"] = {"chunks": counts.get("_pgmres", 0),
                       "fgmres_cycles": counts.get("_pgmres_cycle", 0),
                       "k5_products": sum(k5_lanes.values()),
                       "k3_fused_f64_applies": counts.get(
                           "_fused_apply_flat", 0),
                       "flat_spmvs": counts.get("spmv_flat", 0),
                       "f64_band_applies": counts.get("band_mv", 0),
                       "k1_launches": band_kernel.band_mv_f32_cuda.launches}
        r["k5_products_by_rows"] = dict(sorted(k5_lanes.items()))
        if r["counts"]["k1_launches"]:
            raise AssertionError("K1 launched on the dense tier")
        ev = profile_events(prof, float(np.mean(steady)) * 1e3)
        tables.append(ev.pop("_table"))
        r.update(ev)
        print(f"[dense] n={p.n_free} tier {p._tier}: construction "
              f"{r['ctor_s']:.2f} s (inverse {p._inv_build_s:.3f} s); sweep "
              f"first {r['sweep_first_s']:.3f} s, steady "
              f"{', '.join(f'{t:.3f}' for t in steady)} s; worst rel err "
              f"{r['worst_rel_err']:.3e} at {r['worst_at_hz']:.3f} Hz; device "
              f"busy {ev['device_busy_ms']:.1f} ms of {ev['wall_ms']:.1f} ms "
              f"(idle {100 * ev['idle_share']:.1f} %), "
              f"{ev['kernel_launches']['count']} launches; counts "
              f"{r['counts']}; K5 by rows {r['k5_products_by_rows']}",
              flush=True)
        for kind, ms in ev["device_ms_by_kind"].items():
            print(f"[dense]   {kind:26s} {ms:9.3f} ms "
                  f"({100 * ms / ev['device_busy_ms']:.1f} %)", flush=True)
        r["kernels"] = k3_k5_times(p, cs)
        rec[f"n{p.n_free}"] = r
        del p
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_dense_profile.txt"), "w") as fh:
        fh.write("\n\n".join(tables))
    return rec


def fd_cpu() -> dict:
    """--fd-cpu: J against central differences, and GN, at n = 1466."""
    p = build("cpu", refine=1.0, precond="mg", operator_layout="band")
    truth = np.asarray(p.parameters)
    th0 = truth * START
    rec = {"n_free": p.n_free}
    for F in (64, 512):
        freqs = np.linspace(40.0, 600.0, F)
        fr = p.solveForward(freqs).numpy()
        rf = p.getResidualFunction(freqs, fr, kind="log_afc")
        J = rf.value_and_jac(th0)[1].numpy()
        for step in (1e-5, 1e-4, 1e-3, 1e-2):
            dev = []
            for j in range(3):
                e = np.zeros(3)
                e[j] = step * th0[j]
                fd = (rf(th0 + e) - rf(th0 - e)).numpy() / (2 * e[j])
                dev.append(float(np.abs(fd - J[:, j]).max()
                                 / np.abs(J[:, j]).max()))
            rec[f"fd_rel_{F}_step_{step:g}"] = dev
            print(f"[fd-cpu] {F} points, relative step {step:g}: J column vs "
                  f"central difference, max dev / column max "
                  f"{', '.join(f'{d:.3e}' for d in dev)}", flush=True)
    t0 = time.perf_counter()
    res = p.solveInverse(th0, "MSE_LOG_AFC", "gn", ref_fr=(freqs, fr),
                         use_scaling=True, N_steps=8, report=False, log=False)
    rec["gn_s"] = time.perf_counter() - t0
    rec["gn_f_history"] = list(res.f_history)
    rec["gn_rel_err"] = [list((np.asarray(x) * th0 - truth) / truth)
                         for x in res.x_history + [res.x / th0]]
    for k, (f, e) in enumerate(zip(rec["gn_f_history"] + [None],
                                   rec["gn_rel_err"])):
        print(f"[fd-cpu] gn iterate {k}: loss {f}  rel err "
              f"{', '.join(f'{v:+.3e}' for v in e)}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--k1-floors", action="store_true",
                    help="also time K1 without its FMAs and copies")
    ap.add_argument("--tile-count", action="store_true",
                    help="only count the band's tile occupancy (host, CPU)")
    ap.add_argument("--gn", action="store_true",
                    help="only profile one steady adjoint r + J")
    ap.add_argument("--dense", action="store_true",
                    help="only profile the dense tier's sweeps (n = 1466 and "
                         "11910) and time K3 and K5")
    ap.add_argument("--fd-cpu", action="store_true",
                    help="only check J against central differences and run "
                         "GN at n = 1466 on the CPU")
    args = ap.parse_args()
    if args.tile_count:
        tile_count()
        return 0
    if args.fd_cpu:
        rec = fd_cpu()
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_fd_cpu.json"), "w") as fh:
            json.dump(rec, fh, indent=1)
        print(json.dumps(rec), flush=True)
        return 0

    import torch
    from torch.profiler import ProfilerActivity, profile

    from plate_inverse_problem_tpu_torch.ops import band_kernel, mg, mixed

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    band_kernel.build()
    if args.dense:
        rec = dense_profile(args, card)
        with open(os.path.join(args.out, "torch_dense_profile.json"),
                  "w") as fh:
            json.dump(rec, fh, indent=1)
        print(json.dumps(rec), flush=True)
        return 0
    if args.gn:
        rec = gn_profile(args, card)
        with open(os.path.join(args.out, "torch_gn_profile.json"), "w") as fh:
            json.dump(rec, fh, indent=1)
        print(json.dumps(rec), flush=True)
        return 0
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    p = build(dev)
    torch.cuda.synchronize()
    rec["ctor_s"] = time.perf_counter() - t0
    rec["pack_build_ms"] = 1e3 * p._pack_build_s
    rec["pack_tiles"] = p._band_pack.vals.shape[0]
    freqs = np.linspace(40.0, 600.0, N_FREQ)

    def sweep():
        y = p.solveForward(freqs)
        torch.cuda.synchronize()
        return y

    t0 = time.perf_counter()
    fr = sweep().cpu().numpy()
    rec["sweep_first_s"] = time.perf_counter() - t0
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep()
        steady.append(time.perf_counter() - t0)
    rec["sweep_steady_s"] = steady
    mean_steady = float(np.mean(steady))
    print(f"[sweep] first {rec['sweep_first_s']:.3f} s, steady "
          f"{', '.join(f'{s:.3f}' for s in steady)} s", flush=True)

    # ---- one profiled steady sweep with counting wrappers -----------------
    counts, lanes = {}, {}
    undo = [count_calls(mixed, nm, counts) for nm in
            ("_pgmres", "_pgmres_cycle", "twogrid_apply", "band_mv")]
    undo += [record_lanes(m, lambda: lanes) for m in (mg, mixed)]
    band_kernel.band_mv_f32_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep()
    for u in undo:
        u()
    rec["counts"] = {
        "chunks": counts.get("_pgmres", 0),
        "fgmres_cycles": counts.get("_pgmres_cycle", 0),
        "twogrid_cycles": counts.get("twogrid_apply", 0),
        "precond_applies": counts.get("twogrid_apply", 0)
        // (1 + mixed._MG_REFINE),
        "f64_band_applies": counts.get("band_mv", 0),
        "k1_launches": band_kernel.band_mv_f32_cuda.launches,
    }
    rec["k1_launches_by_B"] = dict(sorted(lanes.items()))
    if sum(lanes.values()) != rec["counts"]["k1_launches"]:
        raise AssertionError(f"K1 lane histogram {lanes} does not add up to "
                             f"{rec['counts']['k1_launches']} launches")

    ev = profile_events(prof, mean_steady * 1e3)
    table = ev.pop("_table")
    busy_ms = ev["device_busy_ms"]
    rec.update(device_busy_ms=busy_ms,
               idle_share_of_mean_steady=ev["idle_share"],
               device_ms_by_kind=ev["device_ms_by_kind"],
               kernel_launches=ev["kernel_launches"],
               top_kernels=ev["top_kernels"])
    launch = ev["kernel_launches"]
    print(f"[profile] device busy {busy_ms:.1f} ms of a {mean_steady * 1e3:.1f}"
          f" ms mean steady sweep; {launch['count']} kernel launches "
          f"({launch['host_ms']:.1f} ms host); counts {rec['counts']}; K1 "
          f"launches by B {rec['k1_launches_by_B']}", flush=True)
    for kind, ms in rec["device_ms_by_kind"].items():
        print(f"[profile]   {kind:26s} {ms:9.3f} ms "
              f"({100 * ms / busy_ms:.1f} %)", flush=True)

    # ---- accuracy over three band bases -----------------------------------
    errs = [worst_oracle_err(p, freqs, fr)]
    for _ in range(2):
        q = build(dev)
        errs.append(worst_oracle_err(q, freqs, q.solveForward(freqs)
                                     .cpu().numpy()))
        del q
    rec["worst_rel_err_by_basis"] = [e for e, _ in errs]
    rec["worst_at_hz"] = [f for _, f in errs]
    print(f"[oracle] worst rel err vs f64 splu per basis: "
          f"{', '.join(f'{e:.3e} at {f:.3f} Hz' for e, f in errs)}", flush=True)

    if args.k1_floors:
        rec["k1_floors_us"] = k1_floors(p, args.out)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_sweep_profile.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    with open(os.path.join(args.out, "torch_sweep_profile.txt"), "w") as fh:
        fh.write(table)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
