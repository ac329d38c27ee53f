"""K3 (``csrc/csr_mv.cu``) at the shapes the main path launches, on an
NVIDIA GPU: each case against its first cut (``--ab SOURCE``, the C
interface ``csr_mv_f64_launch(data, rowptr, col, xt, y, S, L, n, nnz,
stream)``, bit for bit) and one ``torch.sparse.mm`` on the same CSR (given
the data in CSR order), in turns, beside its bound; with ``--floors``,
where the wide kernel's time goes: text edits of the source each drop one
phase (staging x, staging the entries, the row sums, the stores of y) and
are timed beside it.

Shapes (n = 1466 the bench plate, 20916 the 21k plate, each pattern in
the order of its operator data; S operators, L lanes): the dense tier's FGMRES products (S = 2, L = 1024), its
Rayleigh-Ritz panels (L = 16), the panels' row sums (S = 32, L = 1), the
residual map's chunks (S = 2 and the jacfwd tangents folded, S = 6 / 24,
at L = 512 on the bench plate and L = 128 at 21k), the f32 refinement
product (S = 1, L = 1024).  Prints one line per case and one JSON line.

Run from the repository root:

    python3 .probes/k3_ab.py --ab /path/to/first_cut/csr_mv.cu [--floors]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = [(1466, 2, 1024, "f64"), (1466, 2, 16, "f64"), (1466, 32, 1, "f64"),
         (1466, 2, 512, "f64"), (1466, 6, 512, "f64"),
         (1466, 1, 1024, "f32"), (20916, 2, 128, "f64"),
         (20916, 6, 128, "f64"), (20916, 24, 128, "f64"),
         (20916, 32, 1, "f64"), (20916, 2, 1024, "f64")]
# (source text, replacement) of each floor: one phase of the wide kernel out
FLOORS = {
    "no_stage_x": [("    stage_x<T>(xs, XLD, x, sxl, sxc, p.tile_cols + c0,\n"
                    "               p.col_ptr[t + 1] - c0, l0, LT, L);\n",
                    "")],
    "no_stage_entries": [
        ("    stage_rows<T>(ds, max_nnz, ss, rows, nr, 0, p, data, nnz, 0, "
         "g0, true);\n", "")],
    "no_row_sums": [
        ("        row_sum2<T, G>(acc, ds, ldd, ss, __ldg(p.row_off + i),\n"
         "                       __ldg(p.rowptr + i + 1) - "
         "__ldg(p.rowptr + i), xp,\n"
         "                       XLD);\n",
         "        acc[0][0] = acc[0][1] = xp[(i & 63) * XLD];\n")],
    "no_store_y": [
        ("                ysl[(size_t)l * n + rows[r]] = "
         "ys[(s * LT + l) * ldy + r];",
         "                if (ys[(s * LT + l) * ldy + r] == T(1.2345e-300)) "
         "ysl[0] = T(0);")],
}


def build_floor(name: str, edits, ck, band_kernel):
    """A library of the tree's source with ``edits`` applied, its entry
    points typed as ``ck._lib``'s."""
    text = open(ck.SOURCE).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"k3_ab: floor {name}: source text not found")
        text = text.replace(old, new)
    out = os.path.join(band_kernel.BUILD_DIR, "floors")
    os.makedirs(out, exist_ok=True)
    src, lib_path = (os.path.join(out, f"{name}.cu"),
                     os.path.join(out, f"lib{name}.so"))
    with open(src, "w") as fh:
        fh.write(text)
    res = subprocess.run([band_kernel._nvcc(), *band_kernel.NVCC_FLAGS, "-o",
                          lib_path, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"k3_ab: nvcc failed on {name}:\n{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    for regime in ck.REGIMES:
        for dt in ("f64", "f32"):
            name_ = f"csr_mv_{regime.lower()}_{dt}"
            fn = getattr(lib, name_)
            fn.argtypes = getattr(ck._lib, name_).argtypes
            fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="SOURCE", required=True,
                    help="the first cut's csr_mv.cu")
    ap.add_argument("--floors", action="store_true",
                    help="also time the wide kernel with one phase dropped")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from plate_inverse_problem_tpu_torch.ops import band_kernel
    from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck

    if not torch.cuda.is_available():
        raise SystemExit("k3_ab: no CUDA device; nothing was run.")
    card = cs.card_info()
    print(card, flush=True)
    ck.build()
    base = ck._lib
    floors = ({k: build_floor(k, v, ck, band_kernel) for k, v in
               FLOORS.items()} if args.floors else {})
    ab_name, ab = cs.load_ab_csr(args.ab)
    dev = torch.device("cuda")
    pats = {}
    for refine in (1.0, 4.0):
        # the flat pattern in the order getFRCore gives the operator data
        # (the band layout's at 21k, not CSR order: the kernels read the
        # data through the CSR permutation)
        p = cs.sh_i_problem(dev, refine)
        od = p.getFRCore()[1]
        pats[p.n_free] = ck.build_csr(od["rows"], od["cols"], p.n_free)
        del p, od
    recs = []
    for n, S, L, dt in CASES:
        csr = pats[n]
        tdt = torch.float64 if dt == "f64" else torch.float32
        rng = np.random.default_rng(S * L + n)
        data = torch.as_tensor(rng.standard_normal((S, csr.nnz)), dtype=tdt,
                               device=dev)
        x = (torch.ones(L, n, dtype=tdt, device=dev) if L == 1 else
             torch.as_tensor(rng.standard_normal((L, n)), dtype=tdt,
                             device=dev))
        same = bool(torch.equal(ck.csr_mv_cuda(data, x, csr),
                                ab(data, x, csr)))
        crow = torch.cat([csr.rowptr[:-1].long() + s * csr.nnz
                          for s in range(S)]
                         + [torch.tensor([S * csr.nnz], device=dev)])
        d = data if csr.perm is None else data[:, csr.perm]
        A = torch.sparse_csr_tensor(crow, csr.col.long().repeat(S),
                                    d.reshape(-1), size=(S * n, n))
        xt = x.t().contiguous()
        variants = {"ms": lambda: ck.csr_mv_cuda(data, x, csr),
                    f"{ab_name}_ms": lambda: ab(data, x, csr),
                    "library_ms": lambda: torch.sparse.mm(A, xt)}
        order = list(variants) + list(variants)[::-1]
        times = {k: [] for k in variants}
        for k in order:
            times[k].append(cs.time_ms(variants[k], reps=10)[0])
        rec = {k: float(np.mean(v)) for k, v in times.items()}
        if ck.regime(L) == "wide":
            for name, lib in floors.items():
                ck._lib = lib
                rec[f"{name}_ms"] = cs.time_ms(
                    lambda: ck.csr_mv_cuda(data, x, csr), reps=10)[0]
            ck._lib = base
        bound, bound_by = cs.csr_bound_ms(csr, S, L, 8 if dt == "f64" else 4)
        rec.update(n=n, S=S, L=L, dtype=dt, regime=ck.regime(L),
                   identical_to_ab=same, bound_ms=bound, bound_by=bound_by)
        recs.append(rec)
        print(f"[k3_ab] n={n} {dt} S={S} L={L} ({rec['regime']}): same bits "
              f"as {ab_name} {same}; kernel {rec['ms']:.4f}  " + "  ".join(
                  f"{k[:-3]} {v:.4f}" for k, v in rec.items()
                  if k.endswith("_ms")) + f" ms ({bound_by}), kernel at "
              f"{100 * bound / rec['ms']:.1f} % of the bound", flush=True)
        del A, xt, data, d, x
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "cases": recs}), flush=True)
    if not all(r["identical_to_ab"] for r in recs):
        raise SystemExit("k3_ab: the kernel's bits differ from the A/B's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
