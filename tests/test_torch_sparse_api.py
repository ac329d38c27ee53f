"""The port's standalone sparse API (plate_inverse_problem_tpu_torch/ops/
sparse_api.py: ``create_symbolic``, ``find_permutation``, ``matvec``,
``spsolve``) held against the JAX package's ``ops/sparse_api.py`` on the
CPU: the JAX package's tests/test_sparse_api.py cases, each on the same
numpy inputs through both functions.

Tolerances: the host functions must agree exactly; products to 1e-13 of
max |y| (K3's plain version and XLA's scatter sum in other orders);
solves to 1e-12 relative (two f64 LU solves of well-conditioned systems)
and to scipy's splu at the JAX test's rtol 1e-9; gradients against
central differences at the JAX test's 2e-5 and against the JAX gradient
to 1e-10; the Hessian symmetric to 1e-7 and against the JAX Hessian to
1e-8 (both the JAX test's kind of bound); on the bench operator at its
resonance, one round of the port's refinement (against K3's exact
product) to 1e-11 of a longdouble-refined splu, which neither unrefined
LU reaches.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops import sparse_api as jsa
from plate_inverse_problem_tpu_torch import ops as tops
from plate_inverse_problem_tpu_torch.ops import sparse_api as tsa
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _random_system(n, rng, dtype=np.float64, dups=False):
    """Well-conditioned sparse system with a guaranteed-dominant diagonal
    (the JAX test's)."""
    nnz = 4 * n
    r = np.concatenate([rng.integers(0, n, nnz), np.arange(n)])
    c = np.concatenate([rng.integers(0, n, nnz), np.arange(n)])
    if np.issubdtype(dtype, np.complexfloating):
        v = rng.standard_normal(r.size) + 1j * rng.standard_normal(r.size)
    else:
        v = rng.standard_normal(r.size)
    v[-n:] = 10.0 + v[-n:]
    A = sp.coo_matrix((v.astype(dtype), (r, c)), shape=(n, n))
    return A if dups else A.tocsc().tocoo()


def _system(n, seed, dtype=np.float64):
    """(scipy A, port pattern, JAX pattern, data in the canonical order)."""
    A = _random_system(n, np.random.default_rng(seed), dtype)
    idx = np.stack([A.row, A.col], axis=1).astype(np.int32)
    (rows, cols), pat = tsa.create_symbolic(n, idx, dtype)
    _, pat_j = jsa.create_symbolic(n, idx, dtype)
    key = cols.astype(np.int64) * n + rows
    data = np.zeros(len(rows), dtype)
    np.add.at(data, np.searchsorted(key, A.col.astype(np.int64) * n + A.row),
              A.data)
    return A, pat, pat_j, data


def test_create_symbolic_csc_order_and_duplicates():
    rng = np.random.default_rng(0)
    n = 30
    A = _random_system(n, rng, dups=True)
    idx = np.stack([A.row, A.col], axis=1).astype(np.int32)
    (rows, cols), pat = tsa.create_symbolic(n, idx)
    (rows_j, cols_j), pat_j = jsa.create_symbolic(n, idx)
    np.testing.assert_array_equal(rows, rows_j)
    np.testing.assert_array_equal(cols, cols_j)
    Ac = A.tocsc().tocoo()
    np.testing.assert_array_equal(rows, Ac.row)
    np.testing.assert_array_equal(cols, Ac.col)
    assert (pat.n, pat.nnz) == (pat_j.n, pat_j.nnz) == (n, Ac.nnz)
    assert pat == tsa.create_symbolic(n, idx)[1]
    assert hash(pat) == hash(tsa.create_symbolic(n, idx)[1])
    assert tops.FAMILIES == jsa.FAMILIES
    with pytest.raises(ValueError):
        tsa.create_symbolic(n, idx + n)


def test_find_permutation_roundtrip():
    rng = np.random.default_rng(1)
    idx = np.unique(rng.integers(0, 40, (50, 2)), axis=0)
    perm = rng.permutation(idx.shape[0])
    p = tsa.find_permutation(idx, idx[perm])
    np.testing.assert_array_equal(idx[p], idx[perm])
    np.testing.assert_array_equal(p, jsa.find_permutation(idx, idx[perm]))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_matvec_forward_and_transpose(dtype):
    """A x and A^T x (one and three right-hand sides) against the JAX
    matvec and scipy; two calls give the same bits."""
    n = 40
    A, pat, pat_j, data = _system(n, 2, dtype)
    rng = np.random.default_rng(12)
    for x in (rng.standard_normal(n).astype(dtype),
              rng.standard_normal((3, n)).astype(dtype)):
        for tr, ref in ((False, A), (True, A.T)):
            y = tops.matvec(pat, torch.as_tensor(data), torch.as_tensor(x),
                            transpose=tr)
            y_j = np.asarray(jax.vmap(lambda v: jsa.matvec(
                pat_j, jnp.asarray(data), v, transpose=tr))(
                    jnp.asarray(np.atleast_2d(x)))).reshape(x.shape)
            y_ref = (ref @ np.atleast_2d(x).T).T.reshape(x.shape)
            scale = np.abs(y_ref).max()
            assert np.abs(y.numpy() - y_j).max() <= 1e-13 * scale
            assert np.abs(y.numpy() - y_ref).max() <= 1e-13 * scale
            assert torch.equal(y, tops.matvec(pat, torch.as_tensor(data),
                                              torch.as_tensor(x),
                                              transpose=tr))


def test_matvec_gradients_match_jax():
    """The cotangents of ``data`` (the pattern-restricted outer product)
    and of ``vec`` (the transposed product) against JAX's vjp, f64 and
    complex128."""
    n = 30
    for dtype in (np.float64, np.complex128):
        A, pat, pat_j, data = _system(n, 6, dtype)
        rng = np.random.default_rng(16)
        x = rng.standard_normal(n).astype(dtype)
        w = rng.standard_normal(n).astype(dtype)

        def loss_j(d, v):
            y = jsa.matvec(pat_j, d, v)
            return jnp.real(jnp.vdot(jnp.asarray(w), y))

        gd_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(data),
                                                      jnp.asarray(x))
        d = torch.as_tensor(data).requires_grad_(True)
        v = torch.as_tensor(x).requires_grad_(True)
        y = tops.matvec(pat, d, v)
        loss = torch.real(torch.vdot(torch.as_tensor(w), y))
        gd, gx = torch.autograd.grad(loss, (d, v))
        # JAX's complex gradient is the conjugate of torch's convention
        for g, g_j in ((gd, gd_j), (gx, gx_j)):
            g_j = np.conj(np.asarray(g_j))
            assert np.abs(g.numpy() - g_j).max() <= 1e-13 * np.abs(g_j).max()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_spsolve_matches_splu_and_jax(dtype):
    """A x = b and A^T x = b against scipy's splu and the JAX spsolve;
    two refinement rounds against K3's product change the solution by no
    more than its rounding."""
    n = 60
    A, pat, pat_j, data = _system(n, 3, dtype)
    b = np.random.default_rng(13).standard_normal(n).astype(dtype)
    for tr, M in ((False, A), (True, A.T)):
        x = tops.spsolve(pat, torch.as_tensor(data), torch.as_tensor(b),
                         transpose=tr).numpy()
        x_ref = spla.splu(M.tocsc()).solve(b)
        np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-12)
        x_j = np.asarray(jsa.spsolve(pat_j, jnp.asarray(data),
                                     jnp.asarray(b), transpose=tr))
        assert np.abs(x - x_j).max() <= 1e-12 * np.abs(x_j).max()
        x2 = tops.spsolve(pat, torch.as_tensor(data), torch.as_tensor(b),
                          transpose=tr, refine_steps=2).numpy()
        assert np.abs(x2 - x).max() <= 1e-13 * np.abs(x).max()


def test_spsolve_gradient_vs_fd_and_jax():
    """d(w . x)/d data and /d b against central differences (the JAX
    test's 2e-5) and against the JAX gradient (1e-10)."""
    n = 25
    A, pat, pat_j, data = _system(n, 4)
    rng = np.random.default_rng(14)
    b = rng.standard_normal(n)
    w = rng.standard_normal(n)

    def loss(d, bb):
        return torch.dot(torch.as_tensor(w), tops.spsolve(pat, d, bb))

    d = torch.as_tensor(data).requires_grad_(True)
    bt = torch.as_tensor(b).requires_grad_(True)
    gd, gb = torch.autograd.grad(loss(d, bt), (d, bt))
    gd_j, gb_j = jax.grad(
        lambda dd, bb: jnp.dot(jnp.asarray(w), jsa.spsolve(pat_j, dd, bb)),
        argnums=(0, 1))(jnp.asarray(data), jnp.asarray(b))
    for g, g_j in ((gd, gd_j), (gb, gb_j)):
        g_j = np.asarray(g_j)
        assert np.abs(g.numpy() - g_j).max() <= 1e-10 * np.abs(g_j).max()
    eps = 1e-6
    for k in [0, 7, len(data) // 2, len(data) - 1]:
        dp, dm = data.copy(), data.copy()
        dp[k] += eps
        dm[k] -= eps
        fd = (float(loss(torch.as_tensor(dp), torch.as_tensor(b)))
              - float(loss(torch.as_tensor(dm), torch.as_tensor(b))))
        fd /= 2 * eps
        np.testing.assert_allclose(float(gd[k]), fd, rtol=2e-5)


def test_spsolve_vmap_and_hessian_compose():
    """The JAX test's composition: ``torch.func.vmap`` over right-hand
    sides (one factorization) equal to one call each and to splu; the
    Hessian of (w . x(theta))^2 through a backward that is itself
    differentiable, symmetric, against JAX's ``jax.hessian`` and a central
    difference of the gradient; ``torch.func.hessian`` (forward over
    reverse, the jvp rule) agrees."""
    n = 15
    A, pat, pat_j, data = _system(n, 5)
    rng = np.random.default_rng(15)
    B = rng.standard_normal((4, n))
    d0 = torch.as_tensor(data)
    X = torch.func.vmap(lambda bb: tops.spsolve(pat, d0, bb))(
        torch.as_tensor(B))
    lu = spla.splu(A.tocsc())
    for i in range(4):
        xi = tops.spsolve(pat, d0, torch.as_tensor(B[i]))
        assert torch.equal(X[i], xi)
        np.testing.assert_allclose(X[i].numpy(), lu.solve(B[i]), rtol=1e-9,
                                   atol=1e-12)

    w = rng.standard_normal(n)
    th0 = np.array([1.0, 2.0])

    def f(th):
        d = th[0] * d0 + th[1] * d0 ** 2 / 10.0
        return torch.dot(torch.as_tensor(w),
                         tops.spsolve(pat, d, torch.as_tensor(B[0]))) ** 2

    def f_j(th):
        d = th[0] * jnp.asarray(data) + th[1] * jnp.asarray(data) ** 2 / 10.0
        return jnp.dot(jnp.asarray(w),
                       jsa.spsolve(pat_j, d, jnp.asarray(B[0]))) ** 2

    t0 = torch.as_tensor(th0)
    H = torch.autograd.functional.hessian(f, t0, create_graph=False).numpy()
    H_j = np.asarray(jax.hessian(f_j)(jnp.asarray(th0)))
    np.testing.assert_allclose(H, H.T, rtol=1e-7)
    assert np.abs(H - H_j).max() <= 1e-8 * np.abs(H_j).max()
    assert np.abs(torch.func.hessian(f)(t0).numpy() - H).max() \
        <= 1e-10 * np.abs(H).max()
    g = torch.func.grad(f)
    eps = 1e-5
    e0 = torch.tensor([eps, 0.0], dtype=torch.float64)
    fd = (g(t0 + e0)[0] - g(t0 - e0)[0]) / (2 * eps)
    np.testing.assert_allclose(H[0, 0], float(fd), rtol=1e-4)


def test_spsolve_refinement_reaches_refined_splu_at_resonance():
    """On the bench operator A = K - omega^2 M + i K_im (``sh_i`` refine =
    1, n = 1466, the equilibrated data of ``getFRCore``) at its resonance
    (150.68 Hz), one round of refinement against K3's exact product takes
    ``spsolve`` to 1e-11 of the longdouble-refined splu (oracle.py's
    recipe), where the unrefined LU — the port's and the JAX package's
    alike — is the conditioning's kappa * eps off (1e-10 to 1e-8)."""
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(100e-3, 20e-3, 2e-3,
                                                      None, None))
    p = pt.Problem(geom, mat, acc, device="cpu")
    od = p.getFRCore()[1]
    (Ar, Ai), (Br, Bi), (Dr, Di) = mat.abd_split(
        torch.as_tensor(p.parameters), 2e-3)
    K_re = torch.einsum("mk,mkn->n", torch.stack([Ar, Br, Dr]), od["ABD"])
    K_im = torch.einsum("mk,mkn->n", torch.stack([Ai, Bi, Di]), od["ABD"])
    om2 = (2.0 * np.pi * 150.68) ** 2
    d_flat = (K_re - om2 * od["MIn"]).numpy() + 1j * K_im.numpy()
    n = p.n_free
    rows, cols = od["rows"].numpy(), od["cols"].numpy()
    (cr, cc), pat = tsa.create_symbolic(n, np.stack([rows, cols], axis=1))
    pos = np.searchsorted(cc.astype(np.int64) * n + cr,
                          cols.astype(np.int64) * n + rows)
    data = d_flat[np.argsort(pos)]
    A = sp.csc_matrix((data, (cr, cc)), shape=(n, n))
    b = np.random.default_rng(17).standard_normal(n) * (1 + 1j)
    lu = spla.splu(A)
    Al = A.astype(np.clongdouble).tocsr()
    x_true = lu.solve(b).astype(np.clongdouble)
    for _ in range(4):
        x_true = x_true + lu.solve(
            (b.astype(np.clongdouble) - Al @ x_true).astype(np.complex128))
    x_true = x_true.astype(np.complex128)

    def err(x):
        return np.abs(x - x_true).max() / np.abs(x_true).max()

    x0 = tops.spsolve(pat, torch.as_tensor(data), torch.as_tensor(b))
    x1 = tops.spsolve(pat, torch.as_tensor(data), torch.as_tensor(b),
                      refine_steps=1)
    x_j = np.asarray(jsa.spsolve(jsa.create_symbolic(
        n, np.stack([rows, cols], axis=1))[1], jnp.asarray(data),
        jnp.asarray(b)))
    assert err(x1.numpy()) <= 1e-11
    assert err(x1.numpy()) < 1e-2 * min(err(x0.numpy()), err(x_j))
