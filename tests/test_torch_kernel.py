"""The port's hand-written CUDA kernels on the card: K1, the f32 band
matvec (``csrc/band_mv.cu``), K3, the stacked CSR matvec of the flat
pattern (``csrc/csr_mv.cu``), and K7a / K7b, the FGMRES cycle's Givens
least squares (``csrc/fgmres_lsq.cu``).

These tests need an NVIDIA GPU and nvcc; without one they skip.  They import
no jax, so they run on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_kernel.py -q

K1 reads the band's packed nonzero tiles (``pack_band_tiles``); its plain
version reads the same pack.  K3 reads the pattern's CSR copy
(``build_csr``); its plain version is the ``index_add_`` scatter.
Tolerances: K1 against its plain version to 1e-5 of max |y| (the f32 sums
of a row run in another order); K3 to 1e-12 of max |y| in f64 and 1e-5 in
f32 with each of its three kernels, one launch a call, two launches and
two sweeps bit for bit (it sums in one fixed order), and the same bits
from a non-contiguous x;
K3's long rows (more than 256 distinct columns) through the long-row
kernel beside each tile kernel, on mixed, rectangular and all-long
patterns, to the same bounds and bit for bit twice, and at the long-row
kernel's shapes (a row of 257 columns, a row over all of them, P^T-like,
S up to 32, with and without the permutation) to 1e-14 / 1e-5, and the
Chrome trace of long-row products naming K3's kernels as often as the
launch counter counts them;
K3's autograd Function on the card against the CPU's to 1e-12; the FRF
against the host f64 splu oracle to 1e-6 relative (the repo's gate); the
adjoint Gauss-Newton residual and Jacobian on the card against the same
call on the CPU (plain K1), on one set of operator data: r to 3e-6, J to
1e-5 of max |J| (the f32 preconditioner rounds differently, as against
the JAX package); ``polish_peaks`` on the card against the refined splu to
1e-8; K7a and K7b against their plain versions bit for bit, on a seeded
cycle's degenerate and inactive lanes and on every call of a bench sweep.
"""
import functools

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.ops import band as tband
from plate_inverse_problem_tpu_torch.ops import band_kernel
from plate_inverse_problem_tpu_torch.ops import csr_kernel
from plate_inverse_problem_tpu_torch.ops import fgmres_kernel
from plate_inverse_problem_tpu_torch.ops import mixed
from plate_inverse_problem_tpu_torch.ops.band_kernel import pack_band_tiles
from plate_inverse_problem_tpu_torch.oracle import splu_frf

GP = (100e-3, 20e-3, 2e-3, None, None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel)")
    return torch.device("cuda")


def _parts():
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), refine=1.0)
    return geom, mat, acc


@functools.lru_cache(maxsize=1)
def _patterns():
    """The n = 1466 plate pattern (b = 256), a b = 64 synthetic one, and
    the pure-bending path's pattern at n = 13862 (isotropic steel without
    the accelerometer on ``sh_i`` refine = 4: the Morley-only band of the
    two-grid tier, whose packed tiles the sweep's K1 reads)."""
    p = pt.Problem(*_parts(), device="cpu", precond="mg",
                   operator_layout="band")
    geom, mat, acc = _parts()
    q = pt.Problem(pt.Geometry("sh_i", acc, pt.GeometryParams(*GP),
                               refine=4.0), mat, None, device="cpu")
    assert q.is_symmetric_path and q.n_free == 13862
    n, w = 400, 9
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    return [(p.op.pattern.rows, p.op.pattern.cols, p.n_free, {}),
            (rows, cols, n, {"block_multiple": 64, "min_block": 64}),
            (q.op.pattern.rows, q.op.pattern.cols, q.n_free, {})]


def _band(rows, lt, rng, device):
    vals = torch.as_tensor(rng.standard_normal(rows.size),
                           dtype=torch.float32, device=device)
    lin = torch.as_tensor(lt.lin, dtype=torch.int64, device=device)
    return tband.flat_to_band(vals, lt, lin)


def _agree(y, y_ref):
    return float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())


@pytest.mark.cuda
def test_band_kernel_matches_plain(cuda_device):
    """Every pattern of ``_patterns``, the pure-bending path's band among
    them, at B = 1, 3, 128 and 200 lanes."""
    for B in (1, 3, 128, 200):
        for rows, cols, n, kw in _patterns():
            lt = tband.build_band_layout(rows, cols, n, **kw)
            rng = np.random.default_rng(B)
            pack = pack_band_tiles(_band(rows, lt, rng, cuda_device), lt)
            x = torch.as_tensor(rng.standard_normal((B, n)),
                                dtype=torch.float32, device=cuda_device)
            n0 = band_kernel.band_mv_f32_cuda.launches
            y = band_kernel.band_mv_f32(pack, x, lt)
            y_ref = band_kernel.band_mv_f32_reference(pack, x, lt)
            torch.cuda.synchronize()
            assert band_kernel.band_mv_f32_cuda.launches == n0 + 1
            assert _agree(y, y_ref)


@pytest.mark.cuda
def test_band_kernel_ragged(cuda_device):
    """n not a multiple of the 16-row tile (nor of 4, so x rows are not
    16-byte aligned), B = 2, 37, 130 not a multiple of the lane tile: a
    narrow random band, n = 1001, b = 64."""
    n, w = 1001, 21
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    lt = tband.build_band_layout(rows, cols, n, block_multiple=64,
                                 min_block=64)
    assert n % 16 and n % 4
    for B in (2, 37, 130):
        rng = np.random.default_rng(B)
        band = _band(rows, lt, rng, cuda_device)
        pack = pack_band_tiles(band, lt)
        x = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                            device=cuda_device)
        y = band_kernel.band_mv_f32_cuda(pack, x, lt)
        y_ref = band_kernel.band_mv_f32_reference(pack, x, lt)
        torch.cuda.synchronize()
        assert _agree(y, y_ref)
        assert _agree(y, tband.band_mv(band, x, lt))


@pytest.mark.cuda
def test_band_kernel_masks_out_of_range_windows(cuda_device):
    """A band with garbage in the slots outside the operator (edge windows,
    padded tail) still gives the masked product: the pack drops them."""
    rows, cols, n, _ = _patterns()[0]
    lt = tband.build_band_layout(rows, cols, n)
    g = torch.Generator(device="cpu").manual_seed(0)
    band = torch.randn(lt.nb, lt.b, 3 * lt.b, generator=g).to(cuda_device)
    x = torch.randn(5, n, generator=g).to(cuda_device)
    pack = pack_band_tiles(band, lt)
    y = band_kernel.band_mv_f32_cuda(pack, x, lt)
    y_ref = band_kernel.band_mv_f32_reference(pack, x, lt)
    torch.cuda.synchronize()
    assert _agree(y, y_ref)
    assert _agree(y, tband.band_mv(band, x, lt))   # zero-padded windows


@pytest.mark.cuda
def test_band_kernel_non_finite_x_stays_in_its_lane(cuda_device):
    """An inf or NaN in x makes its own lane non-finite at its row (it
    always meets the nonzero diagonal) and leaves the other lanes alone;
    wherever the plain version is finite the kernel agrees with it."""
    rows, cols, n, _ = _patterns()[0]
    lt = tband.build_band_layout(rows, cols, n)
    rng = np.random.default_rng(11)
    pack = pack_band_tiles(_band(rows, lt, rng, cuda_device), lt)
    x = torch.as_tensor(rng.standard_normal((4, n)), dtype=torch.float32,
                        device=cuda_device)
    j, k = n // 3, n - 5
    x[1, j] = float("nan")
    x[2, k] = float("inf")
    y = band_kernel.band_mv_f32_cuda(pack, x, lt).cpu()
    y_ref = band_kernel.band_mv_f32_reference(pack, x, lt).cpu()
    assert torch.isnan(y[1, j]) and not torch.isfinite(y[2, k])
    assert torch.isfinite(y[[0, 3]]).all()
    ok = torch.isfinite(y_ref)
    assert torch.equal(torch.isfinite(y), ok)
    tol = 1e-5 * float(y_ref[ok].abs().max())
    assert float((y[ok] - y_ref[ok]).abs().max()) <= tol


@pytest.mark.cuda
def test_band_kernel_empty_input_launches_nothing(cuda_device):
    rows, cols, n, _ = _patterns()[0]
    lt = tband.build_band_layout(rows, cols, n)
    pack = pack_band_tiles(torch.zeros(lt.nb, lt.b, 3 * lt.b,
                                       device=cuda_device), lt)
    n0 = band_kernel.band_mv_f32_cuda.launches
    y = band_kernel.band_mv_f32_cuda(pack, torch.zeros(0, n,
                                                       device=cuda_device), lt)
    assert y.shape == (0, n)
    assert band_kernel.band_mv_f32_cuda.launches == n0


@pytest.mark.cuda
def test_sweep_on_card_matches_oracle(cuda_device):
    """The small band + two-grid sweep on the card goes through the kernel
    and holds the 1e-6 gate against the host f64 splu oracle."""
    p = pt.Problem(*_parts(), device=cuda_device, precond="mg",
                   operator_layout="band")
    freqs = np.linspace(60.0, 420.0, 8)
    band_kernel.band_mv_f32_cuda.launches = 0
    y = p.solveForward(freqs)
    torch.cuda.synchronize()
    assert band_kernel.band_mv_f32_cuda.launches > 0
    assert y.is_cuda and y.dtype == torch.float64
    y = y.cpu().numpy()
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-6 * ref)


@pytest.mark.cuda
def test_residual_jacobian_on_card_matches_cpu(cuda_device):
    """The inverse half on the card: ``ResidualFunction.value_and_jac``
    (primal sweep, adjoint sweep, residual-map tangents) goes through K1 in
    both sweeps and agrees with the CPU run on the same operator data."""
    p_cpu = pt.Problem(*_parts(), device="cpu", precond="mg",
                       operator_layout="band")
    od = p_cpu.getFRCore()[1]
    p_gpu = pt.Problem(*_parts(), device=cuda_device, precond="mg",
                       operator_layout="band",
                       opdata={k: v.to(cuda_device) for k, v in od.items()})
    freqs = np.linspace(40.0, 300.0, 9)
    truth = np.asarray(p_cpu.parameters)
    ref = p_cpu.solveForward(freqs).numpy()
    th0 = truth * np.array([1.05, 1.02, 1.2])
    r_c, J_c = p_cpu.getResidualFunction(freqs, ref).value_and_jac(th0)
    band_kernel.band_mv_f32_cuda.launches = 0
    r_g, J_g = p_gpu.getResidualFunction(freqs, ref).value_and_jac(th0)
    torch.cuda.synchronize()
    assert band_kernel.band_mv_f32_cuda.launches > 0
    assert r_g.is_cuda and J_g.is_cuda and J_g.shape == (freqs.size, 3)
    r_g, J_g = r_g.cpu().numpy(), J_g.cpu().numpy()
    r_c, J_c = r_c.numpy(), J_c.numpy()
    assert np.abs(r_g - r_c).max() <= 3e-6
    assert np.abs(J_g - J_c).max() <= 1e-5 * np.abs(J_c).max()


@functools.lru_cache(maxsize=1)
def _prolongation():
    """The flat multilevel's prolongation P of the bench plate (1466 x 470:
    the refine = 1 plate onto its factor-2 coarsening, as
    ``Problem(precond="mg", operator_layout="flat")`` builds it)."""
    p = pt.Problem(*_parts(), device="cpu")
    c_mesh, c_free, c_con = p._coarse_level(2.0)
    from plate_inverse_problem_tpu_torch.ops.mg import build_prolongation
    return build_prolongation(p.mesh, c_mesh, p.op.free_idx, c_free,
                              p.op.constrained, c_con,
                              three_field=True).tocoo()


def _csr_cases(device):
    """The bench plate's pattern (n = 1466, in CSR order), a shuffled
    random one with an empty row (n = 1001), and the rectangular P (1466 x
    470, in CSR order) and P^T (470 x 1466, the swapped pattern, read
    through its permutation) of the flat multilevel cycle, each with its
    CSR copy."""
    rows, cols, n, _ = _patterns()[0]
    rng = np.random.default_rng(5)
    m = 1001
    A = (rng.random((m, m)) < 0.01) | np.eye(m, dtype=bool)
    A[m // 2] = False
    r, c = np.nonzero(A)
    perm = rng.permutation(r.size)
    P = _prolongation()
    out = []
    for rr, cc, shape in ((rows, cols, (n, n)), (r[perm], c[perm], (m, m)),
                          (P.row, P.col, P.shape),
                          (P.col, P.row, P.shape[::-1])):
        out.append(csr_kernel.build_csr(
            torch.as_tensor(rr.astype(np.int64), device=device),
            torch.as_tensor(cc.astype(np.int64), device=device), *shape))
    assert out[0].perm is None and out[1].perm is not None
    assert out[2].perm is None and out[3].perm is not None
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S,L", [(torch.float64, 2, 1024),
                                       (torch.float64, 3, 16),
                                       (torch.float32, 6, 37)])
def test_csr_kernel_matches_plain(cuda_device, dtype, S, L):
    """K3 against its plain version: S operators (6: three of the kernel's
    groups of 2 in registers, still one launch), L lanes, f64 and f32, on
    square and rectangular patterns; two launches give the same bits."""
    for csr in _csr_cases(cuda_device):
        rng = np.random.default_rng(S * L)
        data = torch.as_tensor(rng.standard_normal((S, csr.nnz)),
                               dtype=dtype, device=cuda_device)
        x = torch.as_tensor(rng.standard_normal((L, csr.n_cols)),
                            dtype=dtype, device=cuda_device)
        n0 = csr_kernel.csr_mv_cuda.launches
        y = csr_kernel.csr_mv(data, x, csr)
        y_ref = csr_kernel.csr_mv_reference(data, x, csr)
        torch.cuda.synchronize()
        # one kernel a call, whatever S
        assert csr_kernel.csr_mv_cuda.launches == n0 + 1
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        assert float((y - y_ref).abs().max()) <= tol * float(
            y_ref.abs().max())
        assert torch.equal(y, csr_kernel.csr_mv_cuda(data, x, csr))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 3, 16, 33, 1024])
def test_csr_kernel_regimes(cuda_device, dtype, L):
    """Each of K3's kernels (one lane, narrow and wide lanes) at S in {1, 2,
    5, 32} on the bench pattern, a shuffled one and the multilevel cycle's
    P and P^T: against the plain
    version, one launch a call counted under its regime, two calls bit for
    bit, and a non-contiguous x (a transposed view, read by its strides)
    giving the same bits."""
    kind = csr_kernel.regime(L)
    for csr in _csr_cases(cuda_device):
        for S in (1, 2, 5, 32):
            rng = np.random.default_rng(S * L + csr.n)
            data = torch.as_tensor(rng.standard_normal((S, csr.nnz)),
                                   dtype=dtype, device=cuda_device)
            x = torch.as_tensor(rng.standard_normal((L, csr.n_cols)),
                                dtype=dtype, device=cuda_device)
            n0 = csr_kernel.csr_mv_cuda.launches
            r0 = csr_kernel.csr_mv_cuda.launches_by_regime[kind]
            y = csr_kernel.csr_mv_cuda(data, x, csr)
            torch.cuda.synchronize()
            assert csr_kernel.csr_mv_cuda.launches == n0 + 1
            assert csr_kernel.csr_mv_cuda.launches_by_regime[kind] == r0 + 1
            # the plain version's (S, L, seg) products kept under ~1 GB
            seg = max(1, 2**27 // (S * L))
            y_ref = csr_kernel.csr_mv_reference(data, x, csr, seg)
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            assert float((y - y_ref).abs().max()) <= tol * float(
                y_ref.abs().max())
            assert torch.equal(y, csr_kernel.csr_mv_cuda(data, x, csr))
            x_t = x.t().contiguous().t()           # strides (1, L)
            assert not x_t.is_contiguous() or L == 1
            assert torch.equal(y, csr_kernel.csr_mv_cuda(data, x_t, csr))


@pytest.mark.cuda
def test_csr_kernel_sweeps_repeat_bit_for_bit(cuda_device):
    """The dense tier's sweep (n = 1466, K3 in every operator apply) gives
    the same bits twice, and its FRF meets the splu oracle."""
    p = pt.Problem(*_parts(), device=cuda_device)
    freqs = np.linspace(60.0, 420.0, 16)
    csr_kernel.csr_mv_cuda.launches = 0
    y1 = p.solveForward(freqs).cpu().numpy()
    assert csr_kernel.csr_mv_cuda.launches > 0
    y2 = p.solveForward(freqs).cpu().numpy()
    np.testing.assert_array_equal(y1, y2)
    assert np.all(np.abs(y1 - splu_frf(p, freqs)) <= 1e-6 * y1)


@pytest.mark.cuda
def test_csr_apply_autograd_on_card_matches_cpu(cuda_device):
    """K3's autograd Function on the card — the jvp under jacfwd (its vmap
    rule folds the tangents into the operator stack) and the backward —
    against the same Function on the CPU."""
    csr_c = _csr_cases("cpu")[1]
    csr_g = _csr_cases(cuda_device)[1]
    rng = np.random.default_rng(9)
    base = rng.standard_normal((3, 2, csr_c.nnz))
    x = rng.standard_normal((2, 40, csr_c.n))

    def run(csr, device):
        b = torch.as_tensor(base, device=device)
        xx = torch.as_tensor(x, device=device)

        def f(t):
            data = torch.einsum("p,psk->sk", t ** 2 + t, b)
            return csr_kernel.csr_apply(data, xx, csr)

        th = torch.tensor([0.3, -1.2, 0.7], dtype=torch.float64,
                          device=device)
        J = torch.func.jacfwd(f)(th)
        t = th.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((f(t) * xx.sum()).sum(), t)
        return J.cpu(), g.cpu()

    n0 = csr_kernel.csr_mv_cuda.launches
    for a, b in zip(run(csr_g, cuda_device), run(csr_c, "cpu")):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert csr_kernel.csr_mv_cuda.launches > n0


def _long_cases(device):
    """K3 patterns with long rows (more distinct columns than a tile's
    256): a mixed square one (n = 900: a band of 9 columns a row, and every
    37th row with 300-900 distinct random columns), a rectangular 400 x
    3200 one (long rows of 300-3000 columns), both in a shuffled order (the
    data read through the permutation), and a dense 400 x 400 one (every
    row long, no tile), each with its CSR copy."""
    rng = np.random.default_rng(17)
    out = []
    for n_rows, n_cols in ((900, 900), (400, 3200)):
        r, c = [], []
        for i in range(n_rows):
            j = i * n_cols // n_rows
            cols = np.arange(max(0, j - 4), min(n_cols, j + 5))
            if i % 37 == 5:
                k = int(rng.integers(300, min(3000, n_cols) + 1))
                cols = np.union1d(cols, rng.choice(n_cols, k, replace=False))
            r.append(np.full(cols.size, i))
            c.append(cols)
        r, c = np.concatenate(r), np.concatenate(c)
        perm = rng.permutation(r.size)
        out.append((r[perm], c[perm], n_rows, n_cols))
    r, c = np.nonzero(np.ones((400, 400), bool))
    out.append((r, c, 400, 400))
    cases = [csr_kernel.build_csr(torch.as_tensor(r, device=device),
                                  torch.as_tensor(c, device=device), nr, nc)
             for r, c, nr, nc in out]
    assert cases[0].n_tiles > 0 and cases[0].n_long > 0
    assert cases[2].n_tiles == 0 and cases[2].n_long == 400
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 3, 33, 1024])
def test_csr_kernel_long_rows(cuda_device, dtype, L):
    """The long-row regime beside each tile kernel (one lane, narrow,
    wide) on a mixed pattern, a rectangular one and an all-long one, at S
    in {1, 2, 3}: against the plain version (1e-12 / 1e-5 of max |y|),
    one launch of the tile kernel where there are tiles and the long-row
    product's kernels (``long_kernels``: 2 from 32 lanes, 3 below), each
    counted under its regime, two calls bit for bit, and a non-contiguous
    x giving the same bits."""
    kind = csr_kernel.regime(L)
    for csr in _long_cases(cuda_device):
        for S in (1, 2, 3):
            rng = np.random.default_rng(S * L + csr.n_cols)
            data = torch.as_tensor(rng.standard_normal((S, csr.nnz)),
                                   dtype=dtype, device=cuda_device)
            x = torch.as_tensor(rng.standard_normal((L, csr.n_cols)),
                                dtype=dtype, device=cuda_device)
            n0 = csr_kernel.csr_mv_cuda.launches
            by = dict(csr_kernel.csr_mv_cuda.launches_by_regime)
            y = csr_kernel.csr_mv_cuda(data, x, csr)
            torch.cuda.synchronize()
            tiles = 1 if csr.n_tiles else 0
            long = csr_kernel.long_kernels(L)
            assert csr_kernel.csr_mv_cuda.launches == n0 + tiles + long
            now = csr_kernel.csr_mv_cuda.launches_by_regime
            assert now["long"] == by["long"] + long
            assert now[kind] == by[kind] + tiles
            y_ref = csr_kernel.csr_mv_reference(data, x, csr)
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            assert float((y - y_ref).abs().max()) <= tol * float(
                y_ref.abs().max())
            assert torch.equal(y, csr_kernel.csr_mv_cuda(data, x, csr))
            x_t = x.t().contiguous().t()
            assert torch.equal(y, csr_kernel.csr_mv_cuda(data, x_t, csr))


def _long_shapes(device):
    """The long-row kernel's shapes, each pattern in CSR order (no
    permutation) and shuffled (the data read through it): a square 2000
    one with a band of 9, a row of exactly 257 distinct columns, a row
    over all 2000 and every 50th row with 300-1500 random ones; and a
    150 x 3000 restriction-like one (P^T: every 4th row over 300-2500
    columns of its own stretch)."""
    rng = np.random.default_rng(23)
    out = []
    for n_rows, n_cols in ((2000, 2000), (150, 3000)):
        r, c = [], []
        for i in range(n_rows):
            j = i * n_cols // n_rows
            cols = np.arange(max(0, j - 4), min(n_cols, j + 5))
            if n_rows == n_cols and i == 7:
                cols = np.sort(rng.choice(n_cols, 257, replace=False))
            elif n_rows == n_cols and i == 1200:
                cols = np.arange(n_cols)
            elif n_rows == n_cols and i % 50 == 21:
                cols = np.union1d(cols, rng.choice(
                    n_cols, int(rng.integers(300, 1501)), replace=False))
            elif n_rows != n_cols and i % 4 == 1:
                w = int(rng.integers(300, 2501))
                a = max(0, min(j, n_cols - w))
                cols = np.arange(a, a + w)
            r.append(np.full(cols.size, i))
            c.append(cols)
        r, c = np.concatenate(r), np.concatenate(c)
        perm = rng.permutation(r.size)
        for rr, cc in ((r, c), (r[perm], c[perm])):
            out.append(csr_kernel.build_csr(
                torch.as_tensor(rr, device=device),
                torch.as_tensor(cc, device=device), n_rows, n_cols))
    assert [csr.perm is None for csr in out] == [True, False] * 2
    assert all(csr.n_long > 0 for csr in out)
    return out


@pytest.mark.cuda
def test_csr_long_rows_trace_matches_counter(cuda_device, tmp_path):
    """K3 products on a pattern with long rows at L = 8 and 64, in one
    ``diagnostics.profile_call`` capture (the process's only one: a later
    capture in a process can lose kernel records): the Chrome trace names
    K3's kernels (``csr_mv_*``) as often as ``csr_mv_cuda.launches``
    counts them, a tile kernel and ``long_kernels(L)`` long-row kernels a
    product."""
    import json
    import os

    from plate_inverse_problem_tpu_torch.diagnostics import profile

    csr = _long_shapes(cuda_device)[1]
    rng = np.random.default_rng(5)
    data = torch.as_tensor(rng.standard_normal((2, csr.nnz)),
                           device=cuda_device)
    xs = [torch.as_tensor(rng.standard_normal((L, csr.n_cols)),
                          device=cuda_device) for L in (8, 64)]

    def products(d):
        return [csr_kernel.csr_mv_cuda(d, x, csr) for x in xs]

    products(data)                   # built and warm, out of the capture
    torch.cuda.synchronize()
    n0 = csr_kernel.csr_mv_cuda.launches
    _, run, _ = profile.profile_call(products, data, label="k3_long_rows",
                                     logdir=str(tmp_path), warmup=False)
    counted = csr_kernel.csr_mv_cuda.launches - n0
    with open(os.path.join(run, profile.TRACE_FILE)) as fh:
        traced = sum(1 for e in json.load(fh)["traceEvents"]
                     if e.get("cat") == "kernel"
                     and "csr_mv_" in e.get("name", ""))
    want = sum(1 + csr_kernel.long_kernels(x.shape[0]) for x in xs)
    assert counted == traced == want, (counted, traced, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 16, 33, 1024])
def test_csr_long_kernel_shapes(cuda_device, dtype, L):
    """The long-row kernel at S in {1, 2, 3, 32} on a row of exactly 257
    distinct columns, a row over all columns, random long rows and a
    rectangular P^T-like pattern, with and without the data's permutation:
    the long-row product's kernels a call (``long_kernels``, counted under
    its regime), two calls bit
    for bit, and within chip_smoke.py's LONG_TOL (1e-14 of max |y|, f64)
    or CSR_TOL (1e-5, f32) of the plain version."""
    tol = 1e-14 if dtype == torch.float64 else 1e-5
    itemsize = 8 if dtype == torch.float64 else 4
    for csr in _long_shapes(cuda_device):
        for S in (1, 2, 3, 32):
            rng = np.random.default_rng(S * L + csr.n_cols)
            data = torch.as_tensor(rng.standard_normal((S, csr.nnz)),
                                   dtype=dtype, device=cuda_device)
            x = torch.as_tensor(rng.standard_normal((L, csr.n_cols)),
                                dtype=dtype, device=cuda_device)
            by = dict(csr_kernel.csr_mv_cuda.launches_by_regime)
            y = csr_kernel.csr_mv_cuda(data, x, csr)
            y2 = csr_kernel.csr_mv_cuda(data, x, csr)
            torch.cuda.synchronize()
            assert csr_kernel.csr_mv_cuda.launches_by_regime["long"] == \
                by["long"] + 2 * csr_kernel.long_kernels(L)
            assert torch.equal(y, y2)
            seg = max(1024, 2**31 // (S * L * itemsize))
            y_ref = csr_kernel.csr_mv_reference(data, x, csr, seg)
            assert float((y - y_ref).abs().max()) <= tol * float(
                y_ref.abs().max()), (csr.n, csr.perm is None, S)


@pytest.mark.cuda
def test_polish_peaks_on_card_meets_refined_splu(cuda_device):
    """``polish_peaks`` on the bench plate (n = 1466) on the card, theta
    off the basis point: its correction sweep runs K3, the polished peak
    meets the longdouble-refined splu to 1e-8 (the JAX test's bound), and
    ``solveForward(polish_peaks=True)`` gives a CUDA tensor of the same
    values."""
    from plate_inverse_problem_tpu_torch.diagnostics import polish_peaks

    p = pt.Problem(*_parts(), device=cuda_device)
    th = np.asarray(p.parameters) * np.array([1.1, 0.9, 1.2])
    freqs = np.linspace(40.0, 600.0, 64)
    fr = p.solveForward(freqs, th)
    csr_kernel.reset_launches()
    fr_pol, info = polish_peaks(p, freqs, fr=fr, params=th)
    assert info["mode"] == "residual" and csr_kernel.csr_mv_cuda.launches > 0
    i = info["indices"]
    ref = splu_frf(p, freqs[i], th)
    assert np.all(np.abs(fr_pol[i] - ref) <= 1e-8 * np.abs(ref))
    fr_sf = p.solveForward(freqs, th, polish_peaks=True)
    assert fr_sf.is_cuda
    np.testing.assert_allclose(fr_sf.cpu().numpy(), fr_pol, rtol=1e-12,
                               atol=0.0)


def _recorded(fn):
    """The calls of K7a / K7b that ``fn()`` makes through the names
    ``ops/mixed.py`` calls: (name, their arguments cloned before the
    call)."""
    calls, saved = [], (mixed.givens_step, mixed.backsub)

    def recorder(name, kernel):
        def call(*args):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)))
            return kernel(*args)
        return call

    mixed.givens_step = recorder("givens_step", saved[0])
    mixed.backsub = recorder("backsub", saved[1])
    try:
        fn()
    finally:
        mixed.givens_step, mixed.backsub = saved
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 512])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 24, 64])
def test_fgmres_kernels_match_plain_bits(cuda_device, k, L):
    """K7a ``givens_step`` at every step of a seeded cycle of L lanes
    (``synthetic_cycle``: a = 0, b = 0, both zero, inactive and
    underflowing lanes) and K7b ``backsub`` after it, at a k in each of
    the kernels' width buckets (8, 16, 32, 64; k below, at and between
    them): the kernels' outputs are the plain versions' bits on the same
    inputs."""
    state, steps, _, _, j_fin = fgmres_kernel.synthetic_cycle(
        L, k, seed=k, device=cuda_device)

    def cycle():
        for j, s in enumerate(steps):
            mixed.givens_step(
                s["hre"], s["him"], s["hlast"],
                *(state[key] for key in fgmres_kernel.STATE_KEYS),
                s["active"], j, j == 0)
        mixed.backsub(state["R"], state["g"],
                      torch.as_tensor(j_fin, device=cuda_device))

    n0 = fgmres_kernel.givens_step_cuda.launches
    calls = _recorded(cycle)
    torch.cuda.synchronize()
    assert fgmres_kernel.givens_step_cuda.launches == n0 + k
    assert fgmres_kernel.bucket(k) == min(b for b in (8, 16, 32, 64)
                                          if b >= k)
    differ, worst = fgmres_kernel.compare(calls)
    assert len(calls) == k + 1 and differ == 0, (differ, worst)


@pytest.mark.cuda
def test_fgmres_kernels_refuse_what_they_do_not_take(cuda_device):
    """A k past the widest bucket (64) and a state tensor off its 16-byte
    alignment raise; nothing falls back to the plain version."""
    fgmres_kernel.reset_launches()
    assert fgmres_kernel.bucket(65) == 0
    state, steps, _, _, j_fin = fgmres_kernel.synthetic_cycle(
        4, 65, device=cuda_device)
    s = steps[0]
    with pytest.raises(ValueError):
        fgmres_kernel.givens_step_cuda(
            s["hre"], s["him"], s["hlast"],
            *(state[key] for key in fgmres_kernel.STATE_KEYS), s["active"],
            0, True)
    with pytest.raises(ValueError):
        fgmres_kernel.backsub_cuda(state["R"], state["g"],
                                   torch.as_tensor(j_fin, device=cuda_device))
    state, steps, _, _, _ = fgmres_kernel.synthetic_cycle(
        4, 8, device=cuda_device)
    s = steps[0]
    buf = torch.zeros(4 * 9 + 1, dtype=torch.float64, device=cuda_device)
    hre = buf[1:].view(4, 9)              # contiguous, 8 bytes off
    with pytest.raises(ValueError):
        fgmres_kernel.givens_step_cuda(
            hre, s["him"], s["hlast"],
            *(state[key] for key in fgmres_kernel.STATE_KEYS), s["active"],
            0, True)
    assert fgmres_kernel.givens_step_cuda.launches == 0
    assert fgmres_kernel.backsub_cuda.launches == 0
    assert fgmres_kernel.givens_step_reference.cuda_calls == 0
    assert fgmres_kernel.backsub_reference.cuda_calls == 0


@pytest.mark.cuda
def test_fgmres_kernels_on_sweep(cuda_device):
    """A steady 64-point sweep of the bench plate (n = 1466) goes through
    K7a and K7b and through neither plain version; every call it made,
    replayed, gives the plain versions' bits."""
    p = pt.Problem(*_parts(), device=cuda_device)
    freqs = np.linspace(40.0, 600.0, 64)
    p.solveForward(freqs)
    fgmres_kernel.reset_launches()
    calls = _recorded(lambda: p.solveForward(freqs))
    assert fgmres_kernel.givens_step_cuda.launches > 0
    assert fgmres_kernel.backsub_cuda.launches > 0
    assert fgmres_kernel.givens_step_reference.cuda_calls == 0
    assert fgmres_kernel.backsub_reference.cuda_calls == 0
    differ, worst = fgmres_kernel.compare(calls)
    assert differ == 0, (differ, worst)
