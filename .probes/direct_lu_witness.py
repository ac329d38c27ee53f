"""Why the direct engine factors each matrix as a batch of one, on one
NVIDIA GPU: the bench plate (``sh_i`` refine 1, n = 1466) with a constant
beta pinned to beta(150 Hz) of ``chip_smoke.py`` phase 11 (d)'s material,
through the direct engine.  Prints

* torch's linear-algebra backend (the preferred library, MAGMA present);
* the FRF at 150 Hz solved alone against the same point in a sweep of
  (80, 150, 300) Hz, with the engine as it is (each matrix a batch of
  one) and with the chunk's matrices factored and solved as one batch
  (``batched_direct_sweep`` below): the relative difference of each;
* CUDA-event times of ``lu_factor`` + ``lu_solve`` for 16 matrices of the
  bench plate: one batch of 16 against 16 batches of one.

Run from the repository root:  python3 .probes/direct_lu_witness.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def batched_direct_sweep(K_re, K_im, M_flat, B_re, B_im, omegas, rows, cols,
                         n, chunk=16, *, adjoint=False):
    """``ops/sweep.py``'s direct_sweep with each chunk's matrices factored
    and solved in one batched call (one right-hand side a frequency)."""
    import torch

    from plate_inverse_problem_tpu_torch.ops.sweep import dense_operator

    with torch.no_grad():
        omegas = omegas.to(torch.float64)
        uniq, inv = torch.unique(omegas, return_inverse=True)
        assert uniq.shape[0] == omegas.shape[0] and K_re.dim() == 1
        B = torch.complex(B_re, B_im)
        if adjoint:
            B = B.conj()
        U = torch.empty_like(B)
        order = torch.argsort(inv)
        for lo in range(0, uniq.shape[0], chunk):
            hi = min(lo + chunk, uniq.shape[0])
            A = dense_operator(K_re, K_im, M_flat, uniq[lo:hi], rows, cols, n)
            LU, piv = torch.linalg.lu_factor(A)
            lanes = order[lo:hi]
            X = torch.linalg.lu_solve(LU, piv, B[lanes][:, :, None])
            U[lanes] = X[:, :, 0]
        if adjoint:
            U = U.conj()
        return U.real.contiguous(), U.imag.contiguous()


def main() -> int:
    import torch

    import chip_smoke as cs
    import plate_inverse_problem_tpu_torch as pt
    from plate_inverse_problem_tpu_torch.ops import csr_kernel, sweep

    if not torch.cuda.is_available():
        raise SystemExit("direct_lu_witness: no CUDA device.")
    print(cs.card_info(), flush=True)
    print(f"[lu] torch {torch.__version__}, preferred linalg library "
          f"{torch.backends.cuda.preferred_linalg_library()}, MAGMA "
          f"{torch.cuda.has_magma}", flush=True)
    csr_kernel.build()
    dev = torch.device("cuda")
    f_pin = 150.0
    b_pin = cs.FD_BETA0 * (1.0 + 2.0 * np.pi * f_pin / cs.FD_OMEGA_REF)
    p = cs.sh_i_problem(dev, 1.0, mat=pt.get_material(
        7920.0, "isotropic", E=200e9, G=75e9, beta=b_pin),
        engine="direct", chunk=cs.ENG_CHUNK)
    three = np.asarray(cs.FD_PIN_FREQS)
    engine_sweep = sweep.direct_sweep
    for label, fn in (("engine (batches of one)", engine_sweep),
                      ("one batch a chunk", batched_direct_sweep)):
        sweep.direct_sweep = fn
        try:
            y3 = p.solveForward(three).cpu().numpy()
            y1 = p.solveForward([f_pin]).cpu().numpy()
        finally:
            sweep.direct_sweep = engine_sweep
        rel = abs(y3[1] - y1[0]) / abs(y1[0])
        print(f"[lu] {label}: FRF at {f_pin} Hz in the sweep of "
              f"{tuple(three)} Hz against alone: rel {rel:.3e}", flush=True)

    core, od = p.getFRCore()
    n = p.n_free
    freqs = np.linspace(40.0, 600.0, cs.N_FREQ)[:cs.ENG_CHUNK]
    K = cs.flat_stiffness(p, od)
    A = sweep.dense_operator(K[0], K[1], od["MIn"], torch.as_tensor(
        2.0 * np.pi * freqs, device=dev), od["rows"], od["cols"], n)
    b = torch.randn(A.shape[0], n, 1, dtype=A.dtype, device=dev)

    def one_batch():
        LU, piv = torch.linalg.lu_factor(A)
        return torch.linalg.lu_solve(LU, piv, b)

    def batches_of_one():
        for i in range(A.shape[0]):
            LU, piv = torch.linalg.lu_factor(A[i:i + 1])
            torch.linalg.lu_solve(LU, piv, b[i:i + 1])

    x_b = one_batch()
    x_1 = torch.cat([torch.linalg.lu_solve(*torch.linalg.lu_factor(
        A[i:i + 1]), b[i:i + 1]) for i in range(A.shape[0])])
    diff = float(((x_b - x_1).abs().amax((1, 2))
                  / x_1.abs().amax((1, 2))).max())
    t_b = cs.cuda_event_ms(one_batch, 5)
    t_1 = cs.cuda_event_ms(batches_of_one, 5)
    print(f"[lu] lu_factor + lu_solve of {A.shape[0]} matrices, n={n}: one "
          f"batch {t_b:.3f} ms, batches of one {t_1:.3f} ms; max rel "
          f"difference of the solutions {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
