"""The port's hand-written CUDA band kernel on the card.

These tests need an NVIDIA GPU and nvcc; without one they skip.  They import
no jax, so they run on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_kernel.py -q

The kernel reads the band's packed nonzero tiles (``pack_band_tiles``); its
plain version reads the same pack.  Tolerances: the kernel against its plain
version to 1e-5 of max |y| (the f32 sums of a row run in another order);
the FRF against the host f64 splu oracle to 1e-6 relative (the repo's gate;
f64 atomics in the residual scatter add run-to-run last-bit noise far below
it); the adjoint Gauss-Newton residual and Jacobian on the card against the
same call on the CPU (plain K1), on one set of operator data: r to 3e-6,
J to 1e-5 of max |J| (the f32 preconditioner rounds differently, as
against the JAX package).
"""
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.ops import band as tband
from plate_inverse_problem_tpu_torch.ops import band_kernel
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


def _patterns():
    """The n = 1466 plate pattern (b = 256) and a b = 64 synthetic one."""
    p = pt.Problem(*_parts(), device="cpu", precond="mg",
                   operator_layout="band")
    n, w = 400, 9
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    return [(p.op.pattern.rows, p.op.pattern.cols, p.n_free, {}),
            (rows, cols, n, {"block_multiple": 64, "min_block": 64})]


def _band(rows, lt, rng, device):
    vals = torch.as_tensor(rng.standard_normal(rows.size),
                           dtype=torch.float32, device=device)
    lin = torch.as_tensor(lt.lin, dtype=torch.int64, device=device)
    return tband.flat_to_band(vals, lt, lin)


def _agree(y, y_ref):
    return float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 128, 200])
def test_band_kernel_matches_plain(cuda_device, B):
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
@pytest.mark.parametrize("B", [2, 37, 130])
def test_band_kernel_ragged(cuda_device, B):
    """n not a multiple of the 16-row tile (nor of 4, so x rows are not
    16-byte aligned), B not a multiple of the lane tile: a narrow random
    band, n = 1001, b = 64."""
    n, w = 1001, 21
    rows = np.concatenate([np.full(min(n, i + w + 1) - max(0, i - w), i)
                           for i in range(n)])
    cols = np.concatenate([np.arange(max(0, i - w), min(n, i + w + 1))
                           for i in range(n)])
    lt = tband.build_band_layout(rows, cols, n, block_multiple=64,
                                 min_block=64)
    assert n % 16 and n % 4
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
