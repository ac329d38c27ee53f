"""K3, the flat-pattern operator of the port (``ops/csr_kernel.py``), on
the CPU: the CSR copy the CUDA kernel reads, the dispatch, and the
``torch.autograd.Function`` that the residual map of the adjoint Jacobian
and the loss gradient run through.

On the CPU the Function runs the kernel's plain version (the
``index_add_`` scatter) inside it, so these tests hold the Function's
rules against the plain composite's autograd.  Tolerances: the CSR copy
against the scatter and a dense matmul to 1e-13 of max |y| in f64 (2e-6 in
f32; the sums run in other orders); ``jvp`` (with its ``vmap`` rule) and
``backward`` against the composite's ``torch.func.jacfwd`` /
``torch.autograd.grad`` to 1e-13 of their max; ``ResidualFunction.value_and_jac`` through the
Function against the same call through the composite to 1e-12 (it comes
out equal), the loss gradient to 1e-11 (reverse-mode lane sums in
another order under cancellation: 2e-13 to 9e-13 observed).  The card cases are in tests/test_torch_kernel.py.
"""
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck
from plate_inverse_problem_tpu_torch.ops import mixed as tmixed
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64


def _pattern(seed, n=40, density=0.15, empty_row=True):
    """A shuffled random pattern with a full diagonal (and one empty row)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) < density) | np.eye(n, dtype=bool)
    if empty_row:
        A[n // 2] = False
    r, c = np.nonzero(A)
    perm = rng.permutation(r.size)
    return torch.as_tensor(r[perm]), torch.as_tensor(c[perm]), n


def _csr_numpy(data, x, csr):
    """y from the CSR copy alone, the arrays the kernel reads: values in
    CSR order (data[:, perm]), rowptr, col."""
    d = data if csr.perm is None else data[:, csr.perm.numpy()]
    rowptr, col = csr.rowptr.numpy(), csr.col.numpy()
    prod = d[:, None, :] * x.reshape(-1, csr.n)[:, col][None]
    y = np.zeros(prod.shape[:2] + (csr.n,), prod.dtype)
    for i in range(csr.n):
        y[..., i] = prod[..., rowptr[i]:rowptr[i + 1]].sum(-1)
    return y.reshape((d.shape[0],) + x.shape[:-1] + (csr.n,))


@pytest.mark.parametrize("dtype,S,lead", [
    (np.float64, 2, (7,)), (np.float64, 3, (2, 5)), (np.float32, 1, (33,)),
    (np.float64, 2, (16,))])
def test_csr_copy_matches_scatter_and_dense(dtype, S, lead):
    """build_csr's rowptr/col/perm give the scatter's and a dense matmul's
    product, on a shuffled pattern with an empty row and on a sorted one
    (perm None)."""
    rng = np.random.default_rng(S + len(lead))
    for sorted_ in (False, True):
        rows, cols, n = _pattern(S)
        if sorted_:
            order = torch.as_tensor(np.lexsort((cols.numpy(), rows.numpy())))
            rows, cols = rows[order], cols[order]
        csr = ck.build_csr(rows, cols, n)
        assert (csr.perm is None) == sorted_
        assert csr.rowptr.dtype == torch.int32 and csr.col.dtype == torch.int32
        data = rng.standard_normal((S, rows.numel())).astype(dtype)
        x = rng.standard_normal(lead + (n,)).astype(dtype)
        y = ck.csr_mv(torch.as_tensor(data), torch.as_tensor(x), csr).numpy()
        dense = np.zeros((S, n, n))
        for s in range(S):
            np.add.at(dense[s], (rows.numpy(), cols.numpy()), data[s])
        y_dense = np.einsum("sij,...j->s...i", dense, x.astype(np.float64))
        tol = (1e-13 if dtype == np.float64 else 2e-6) * np.abs(y_dense).max()
        assert y.shape == (S,) + lead + (n,)
        assert np.abs(y - y_dense).max() <= tol
        assert np.abs(_csr_numpy(data, x, csr) - y_dense).max() <= tol


def test_dispatch_and_checks():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses a
    CPU tensor, mixed dtypes and a pattern of another size."""
    rows, cols, n = _pattern(0)
    csr = ck.build_csr(rows, cols, n)
    data = torch.ones(2, rows.numel(), dtype=F64)
    x = torch.ones(3, n, dtype=F64)
    assert torch.equal(ck.csr_mv(data, x, csr),
                       ck.scatter_mv(data, x, rows, cols, n))
    with pytest.raises(ValueError, match="CUDA"):
        ck.csr_mv_cuda(data, x, csr)
    with pytest.raises(TypeError):
        ck.csr_mv_cuda(data, x.float(), csr)
    with pytest.raises(ValueError, match="shape"):
        ck.csr_mv(data[:, 1:], x, csr)
    assert ck.csr_mv_cuda.launches == 0


def _chain(seed):
    """theta (3,) -> an (S=2, nnz) operator stack on a random pattern,
    quadratic in theta (as the material chain is nonlinear), and x."""
    rows, cols, n = _pattern(seed)
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.standard_normal((3, 2, rows.numel())))
    x = torch.as_tensor(rng.standard_normal((2, 5, n)))
    th = torch.as_tensor(rng.standard_normal(3))
    csr = ck.build_csr(rows, cols, n)

    def data(t):
        return torch.einsum("p,psk->sk", t ** 2 + t, base)

    def k3(t):
        return ck.csr_apply(data(t), x, csr, 7)

    def plain(t):
        return ck.scatter_mv(data(t), x, rows, cols, n, 7)

    return th, x, csr, data, k3, plain


def _close(a, b, tol=1e-13):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("rule", ["jvp", "backward", "x_is_constant"])
def test_function_rules_match_composite(rule):
    """The Function's jvp (under jacfwd = vmap of jvp, its vmap rule
    folding the tangents into the stack) and backward (a gather and a lane
    sum) against the plain composite; a derivative in x raises."""
    th, x, csr, data, k3, plain = _chain(3)
    if rule == "jvp":
        assert _close(torch.func.jacfwd(k3)(th), torch.func.jacfwd(plain)(th))
    elif rule == "backward":
        w = torch.randn(k3(th).shape, dtype=F64,
                        generator=torch.Generator().manual_seed(0))
        grads = []
        for f in (k3, plain):
            t = th.clone().requires_grad_(True)
            grads.append(torch.autograd.grad((f(t) * w).sum(), t)[0])
        assert _close(*grads)
    else:
        d = data(th)
        xr = x.clone().requires_grad_(True)
        for transform in (
                lambda: torch.func.vmap(lambda v: ck.csr_apply(d, v, csr))(x),
                lambda: torch.func.jvp(lambda v: ck.csr_apply(d, v, csr),
                                       (x,), (x,)),
                lambda: torch.autograd.grad(ck.csr_apply(d, xr, csr).sum(),
                                            xr)):
            with pytest.raises(NotImplementedError, match="constant"):
                transform()


@pytest.fixture(scope="module")
def symm_problem():
    """The port's own ``symm`` ny = 1 plate (n = 420), SOL 45 deg, its FRF
    at the truth, and theta_0."""
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc,
                       pt.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                       ny=1)
    mat = pt.get_material(1550.0, "sol", angles=(45.0,), E1=120e9, E2=8.5e9,
                          G12=4.5e9, nu12=0.30, beta=0.006)
    p = pt.Problem(geom, mat, acc, device="cpu")
    freqs = np.linspace(40.0, 500.0, 12)
    fr = p.solveForward(freqs).numpy()
    th0 = np.asarray(p.parameters) * np.array([1.05, 0.97, 1.04, 0.98, 1.2])
    return p, freqs, fr, th0


@pytest.mark.parametrize("call", ["value_and_jac", "loss_grad"])
def test_inverse_half_unchanged(symm_problem, monkeypatch, call):
    """r and J of ResidualFunction("log_afc") and the MSE_LOG_AFC gradient
    through the Function equal the same calls through the plain composite
    (the residual map before K3)."""
    p, freqs, fr, th0 = symm_problem

    def run():
        if call == "value_and_jac":
            rf = p.getResidualFunction(freqs, fr, kind="log_afc")
            return rf.value_and_jac(th0)
        loss = p.getLossFunction(freqs, fr, "MSE_LOG_AFC")
        return loss.value_and_grad(th0)

    out = run()
    monkeypatch.setattr(
        tmixed, "csr_apply",
        lambda data, x, csr, seg=None: ck.scatter_mv(data, x, csr.rows,
                                                     csr.cols, csr.n, seg))
    ref = run()
    # the gradient's reverse mode sums the lanes in another order than the
    # composite's, and -d psi / d theta cancels large terms: 2e-13 to
    # 9e-13 of its max over ARPACK bases, where J (forward mode) is exact
    for a, b in zip(out, ref):
        assert _close(a, b, 1e-12 if call == "value_and_jac" else 1e-11)
