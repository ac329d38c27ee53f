"""The port's re-exports, its ``compat`` layer and K3's long rows, held
against the JAX package on the CPU.

* every name of a JAX subpackage's ``__all__`` (models, ops, utils, io,
  mesh, diagnostics, fem, optimize, parallel) imports from the port's,
  except the two on ROADMAP's "do not port" list (``jacobi_eigh``,
  ``generalized_jacobi_eigh``); ``spmv_flat`` and
  ``static_preconditioner_host`` against the JAX functions; the JAX
  keywords ``Problem(ozaki=...)`` and ``Geometry(mesh=...)`` are taken;
* ``plate_inverse_problem_tpu_torch.compat`` has the JAX ``compat``
  layout, and the script of tests/test_compat.py runs on it (its one
  change besides the import: ``device="cpu"``; chip_smoke.py runs it
  verbatim on the card);
* K3 on a pattern whose rows reach 300-3000 distinct columns (more than a
  tile's 256): the plan hands them to the long-row kernel, and
  ``csr_apply`` (its plain version here) with its data gradient, the
  sparse API's ``matvec`` and ``spsolve`` agree with scipy and the JAX
  functions to 1e-12 / 1e-10.  The card's kernel is tested in
  tests/test_torch_kernel.py.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops import mixed as jmixed
from plate_inverse_problem_tpu.ops import scatter as jscatter
from plate_inverse_problem_tpu.ops import sparse_api as jsa
from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck
from plate_inverse_problem_tpu_torch.ops import sparse_api as tsa
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SUBPACKAGES = ("models", "ops", "utils", "io", "mesh", "diagnostics", "fem",
               "optimize", "parallel")
NOT_PORTED = {"jacobi_eigh", "generalized_jacobi_eigh"}
GP = (100e-3, 20e-3, 2e-3, 10e-3, None)


def _long_pattern(n_rows, n_cols, seed):
    """(rows, cols) in a shuffled order: a band of 9 columns a row, and
    every 37th row with 300 to 3000 distinct random columns (at most
    n_cols); unique pairs."""
    rng = np.random.default_rng(seed)
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
    return r[perm], c[perm]


def test_subpackage_names_import_from_the_port():
    """Each JAX ``__all__`` name, from the port's subpackage of the same
    name, and in its ``__all__``; the two TPU eigh workarounds are the
    only gaps."""
    for sub in SUBPACKAGES:
        jmod = importlib.import_module(f"plate_inverse_problem_tpu.{sub}")
        tmod = importlib.import_module(
            f"plate_inverse_problem_tpu_torch.{sub}")
        names = set(jmod.__all__) - NOT_PORTED
        missing = [n for n in sorted(names) if not hasattr(tmod, n)]
        assert not missing, (sub, missing)
        assert names <= set(tmod.__all__), sub
        gaps = set(jmod.__all__) - set(dir(tmod))
        assert gaps == (NOT_PORTED if sub == "ops" else set()), sub


def test_compat_surface():
    """tests/test_compat.py's script on the port's compat module, and the
    JAX compat layout: the same submodules with the same names."""
    import plate_inverse_problem_tpu.compat as jc
    import plate_inverse_problem_tpu_torch.compat as jp

    acc = jp.Accelerometer.Accelerometer("AP1030")
    geom = jp.Geometry.Geometry(
        "symm", acc, jp.Geometry.GeometryParams(100e-3, 20e-3, 2e-3, 10e-3,
                                                None),
        ny=1,
    )
    mat = jp.Material.get_material(7920.0, "isotropic", E=200e9, G=75e9,
                                   beta=0.003)
    p = jp.Problem.Problem(geom, mat, acc, device="cpu")
    fr = p.solveForward(np.linspace(40, 100, 3))
    assert np.all(np.isfinite(np.asarray(fr)))
    assert hasattr(jp.Optimizers, "optimize_trust_region")
    assert hasattr(jp.Input, "Compressor")
    assert hasattr(jp.Utils, "plot_fr")
    assert hasattr(jp.Sparse, "sweep_solve")
    for name in ("Accelerometer", "Geometry", "Material", "Problem",
                 "Optimizers", "Input", "Utils", "Sparse"):
        jm, tm = getattr(jc, name), getattr(jp, name)
        assert tm.__name__ == f"plate_inverse_problem_tpu_torch.compat.{name}"
        assert ({k for k in vars(jm) if not k.startswith("__")}
                == {k for k in vars(tm) if not k.startswith("__")})
    assert jp.Problem.Problem is pt.Problem


def test_spmv_flat_and_static_preconditioner_match_jax():
    """``spmv_flat`` (K3's plain version here) against the JAX scatter,
    forward and transposed, on a rectangular pattern with repeated pairs
    (they add) and batched x, to 1e-13; ``static_preconditioner_host``
    (the port's f64 inverse) against the JAX function's f32 one to f32
    rounding, and its own f64 product with the matrix to 1e-10."""
    from plate_inverse_problem_tpu_torch.ops import (
        spmv_flat, static_preconditioner_host)

    rng = np.random.default_rng(4)
    n_rows, n_cols = 50, 70
    rows = rng.integers(0, n_rows, 400)
    cols = rng.integers(0, n_cols, 400)
    data = rng.standard_normal(400)
    for tr, n_out, width in ((False, n_rows, n_cols), (True, n_cols,
                                                       n_rows)):
        x = rng.standard_normal((3, 2, width))
        y = spmv_flat(torch.as_tensor(data), torch.as_tensor(rows),
                      torch.as_tensor(cols), torch.as_tensor(x), n_out,
                      transpose=tr).numpy()
        y_j = np.asarray(jscatter.spmv_flat(jnp.asarray(data),
                                            jnp.asarray(rows),
                                            jnp.asarray(cols),
                                            jnp.asarray(x), n_out,
                                            transpose=tr))
        assert y.shape == y_j.shape == (3, 2, n_out)
        assert np.abs(y - y_j).max() <= 1e-13 * np.abs(y_j).max()
    n = 40
    A = sp.random(n, n, density=0.2, random_state=5)
    A = (A + A.T + 10.0 * sp.eye(n)).tocoo()
    inv = static_preconditioner_host(A.data, A.row, A.col, n)
    inv_j = jmixed.static_preconditioner_host(A.data, A.row, A.col, n)
    assert inv.dtype == np.float64 and inv_j.dtype == np.float32
    assert np.abs(inv - inv_j).max() <= 1e-6 * np.abs(inv_j).max()
    assert np.abs(inv @ A.toarray() - np.eye(n)).max() <= 1e-10


def test_jax_keywords_of_problem_and_geometry():
    """``Problem(ozaki=...)`` is accepted and changes nothing (the TPU's
    f64 emulation switch); ``Geometry(mesh=m, height=h)`` takes a mesh."""
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pt.Geometry("symm", acc, pt.GeometryParams(*GP), ny=1)
    freqs = np.linspace(100.0, 200.0, 3)
    fr = [pt.Problem(geom, mat, acc, device="cpu", **kw).solveForward(freqs)
          for kw in ({}, {"ozaki": True})]
    assert torch.equal(*fr)
    g2 = pt.Geometry(mesh=geom.get_mesh(), height=2e-3)
    assert g2.get_mesh() is geom.get_mesh()


def test_long_row_plan_and_csr_apply():
    """The plan lists exactly the rows of more than 256 distinct columns
    as long rows (square, and rectangular with 3200 columns); the plain
    product and ``csr_apply``'s data gradient against scipy / numpy to
    1e-12 of their max."""
    rng = np.random.default_rng(8)
    for n_rows, n_cols in ((900, 900), (400, 3200)):
        r, c = _long_pattern(n_rows, n_cols, n_cols)
        csr = ck.build_csr(torch.as_tensor(r), torch.as_tensor(c), n_rows,
                           n_cols)
        counts = np.bincount(r, minlength=n_rows)
        expect = np.nonzero(counts > ck.MAX_TILE_COLS)[0]
        assert csr.long_rows.numpy().tolist() == expect.tolist()
        assert counts[expect].min() >= 300 and counts.max() <= 3009
        assert csr.n_tiles > 0 and csr.max_cols <= ck.MAX_TILE_COLS
        data = rng.standard_normal((2, r.size))
        x = rng.standard_normal((5, n_cols))
        d = torch.as_tensor(data).requires_grad_(True)
        y = ck.csr_apply(d, torch.as_tensor(x), csr)
        for s in range(2):
            A = sp.csr_matrix((data[s], (r, c)), shape=(n_rows, n_cols))
            y_ref = (A @ x.T).T
            assert (np.abs(y[s].detach().numpy() - y_ref).max()
                    <= 1e-12 * np.abs(y_ref).max())
        gy = rng.standard_normal((2, 5, n_rows))
        (g,) = torch.autograd.grad(y, d, torch.as_tensor(gy))
        g_ref = np.einsum("slk,lk->sk", gy[:, :, r], x[:, c])
        assert np.abs(g.numpy() - g_ref).max() <= 1e-12 * np.abs(g_ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_long_rows_through_the_sparse_api(dtype):
    """``matvec`` (A and A^T) against scipy and the JAX function to 1e-12,
    ``spsolve`` against scipy's splu and the JAX function to 1e-10, with
    one refinement round against K3's exact product, on a diagonally
    dominant system with rows of 300-600 distinct columns."""
    n = 600
    r, c = _long_pattern(n, n, 11)
    rng = np.random.default_rng(12)
    v = rng.standard_normal(r.size)
    if dtype == np.complex128:
        v = v + 1j * rng.standard_normal(r.size)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A = (A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)).tocsc().tocoo()
    idx = np.stack([A.row, A.col], axis=1).astype(np.int32)
    (rows, cols), pat = tsa.create_symbolic(n, idx, dtype)
    _, pat_j = jsa.create_symbolic(n, idx, dtype)
    key = cols.astype(np.int64) * n + rows
    data = np.zeros(len(rows), dtype)
    data[np.searchsorted(key, A.col.astype(np.int64) * n + A.row)] = A.data
    assert pat.plans("cpu")[0].n_long > 0
    x = rng.standard_normal((3, n)).astype(dtype)
    for tr, M in ((False, A), (True, A.T)):
        y = tsa.matvec(pat, torch.as_tensor(data), torch.as_tensor(x),
                       transpose=tr).numpy()
        y_ref = (M @ x.T).T
        y_j = np.asarray(jsa.matvec(pat_j, jnp.asarray(data),
                                    jnp.asarray(x), transpose=tr))
        for other in (y_ref, y_j):
            assert np.abs(y - other).max() <= 1e-12 * np.abs(other).max()
    b = rng.standard_normal(n).astype(dtype)
    xs = tsa.spsolve(pat, torch.as_tensor(data), torch.as_tensor(b),
                     refine_steps=1).numpy()
    x_ref = spla.splu(A.tocsc()).solve(b)
    x_j = np.asarray(jsa.spsolve(pat_j, jnp.asarray(data), jnp.asarray(b)))
    for other in (x_ref, x_j):
        assert np.abs(xs - other).max() <= 1e-10 * np.abs(other).max()
