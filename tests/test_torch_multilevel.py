"""The port's flat multilevel preconditioner (plate_inverse_problem_tpu_torch/
ops/mg.py ``build_multilevel_host``, ``multilevel_to_device``,
``multilevel_apply``; ``Problem(precond="mg")`` on the flat layout) held
against the JAX package on the CPU, on the ``symm`` plates of the JAX
package's tests/test_mg.py (ny = 1 / 2 / 4: 420 / 1386 / 5292 free DOF).

Tolerances: the host function is a copy and must agree exactly (the
coarsest operator's data is kept in f64 by the port, and equals the JAX
f32 data once rounded); the f32 cycle agrees to 1e-5 of max |y|, because
its f32 sums (K3's rows, the coarse GEMM) run in another order than XLA's
scatters (5e-2 at three levels, where the middle level's conditioning
leaves the f32 cycle's result no more digits than that); the contraction
rates are the JAX tests' bounds; the Problem's FRF meets the port's modal
engine at rtol 5e-5 (the JAX test's) and the refined splu oracle at
1e-6.  The rectangular products (P, P^T) of the
plain version equal a scipy product to 1e-14 of max |y|.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.fem.assembly import MODULI_INDICES
from plate_inverse_problem_tpu.ops import mg as jmg
from plate_inverse_problem_tpu_torch.ops import csr_kernel as ck
from plate_inverse_problem_tpu_torch.ops import mg as tmg
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, 10e-3, None)
MAT = dict(E=200e9, G=75e9, beta=0.003)


@functools.lru_cache(maxsize=None)
def _plate(ny):
    """(port Problem, equilibrated K on its pattern, scale vector) of the
    ``symm`` plate: the JAX test's ``_plate`` on the port's host layer."""
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("symm", acc, pt.GeometryParams(*GP), ny=ny)
    mat = pt.get_material(7920.0, "isotropic", **MAT)
    p = pt.Problem(geom, mat, acc, device="cpu")
    op = p.op
    n = p.n_free
    (Ar, _), _, (Dr, _) = mat.abd_split(torch.as_tensor(p.parameters), 2e-3)
    K_flat = sum(float(Ar[i]) * op.mats["A" + s]
                 + float(Dr[i]) * op.mats["D" + s]
                 for i, s in enumerate(MODULI_INDICES))
    rows, cols = op.pattern.rows, op.pattern.cols
    dvals = np.zeros(n)
    dm = rows == cols
    np.add.at(dvals, rows[dm], np.abs(K_flat[dm]))
    s_eq = 1.0 / np.sqrt(np.where(dvals > 0, dvals, 1.0))
    return p, K_flat * s_eq[rows] * s_eq[cols], s_eq


@functools.lru_cache(maxsize=None)
def _chain(nys):
    """Prolongations of the port's plates ``nys`` (finest first)."""
    Ps = []
    for nf, nc in zip(nys, nys[1:]):
        pf, pc = _plate(nf)[0], _plate(nc)[0]
        Ps.append(tmg.build_prolongation(
            pf.mesh, pc.mesh, pf.op.free_idx, pc.op.free_idx,
            pf.op.constrained, pc.op.constrained, three_field=True))
    return tuple(Ps)


def _hierarchy(nys, invert_coarse=True):
    p, K, s_eq = _plate(nys[0])
    args = (K, p.op.pattern.rows, p.op.pattern.cols, p.n_free,
            list(_chain(nys)))
    return (args, s_eq,
            tmg.build_multilevel_host(*args, row_scale=s_eq,
                                      invert_coarse=invert_coarse))


@pytest.mark.parametrize("invert_coarse", [True, False])
def test_build_multilevel_host_matches_jax(invert_coarse):
    """Every array and scalar of the host hierarchy equals the JAX
    function's on the same inputs (three levels: ny = 4, 2, 1)."""
    args, s_eq, (arr, st) = _hierarchy((4, 2, 1), invert_coarse)
    arr_j, st_j = jmg.build_multilevel_host(*args, row_scale=s_eq,
                                            invert_coarse=invert_coarse)
    assert st == st_j and len(arr["levels"]) == 2
    for lv, lv_j in zip(arr["levels"], arr_j["levels"]):
        assert lv.keys() == lv_j.keys()
        for k in lv:
            assert lv[k].dtype == lv_j[k].dtype
            np.testing.assert_array_equal(lv[k], lv_j[k])
    if invert_coarse:
        np.testing.assert_array_equal(arr["Kc_inv32"], arr_j["Kc_inv32"])
    else:
        c, c_j = arr["Kc_coo"], arr_j["Kc_coo"]
        assert c["data"].dtype == np.float64 and c["n"] == c_j["n"]
        np.testing.assert_array_equal(c["data"].astype(np.float32),
                                      c_j["data"])
        for k in ("rows", "cols"):
            np.testing.assert_array_equal(c[k], c_j[k])


@pytest.mark.parametrize("nys,tol", [((2, 1), 1e-5), ((4, 2, 1), 5e-2)])
def test_multilevel_apply_matches_jax(nys, tol):
    """One cycle with one and with two prolongations (a V- and, at three
    levels, a W-cycle) on 3 residual lanes, against the JAX cycle on the
    same hierarchy, to ``tol`` of max |y|.  Two levels: 1e-5, f32 sums in
    another order.  Three levels: the middle level's operator keeps
    physical variables (cond 8.5e9), so its f32 residuals in the W-cycle's
    second visit carry no digits and the cycle's f32 result depends on the
    order of its sums — against the same cycle run in f64 the JAX cycle is
    2.4e-2 of max |y| off and the port's 1.5e-2 (measured on the CPU);
    the FGMRES around it only needs a contraction
    (``test_contraction_rates``)."""
    args, _, (arr, st) = _hierarchy(nys)
    K, rows, cols, n, _ = args
    r = np.random.default_rng(len(nys)).standard_normal((3, n))
    y_j = np.asarray(jmg.multilevel_apply(
        jax.tree_util.tree_map(jnp.asarray, arr), st, jnp.asarray(K),
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(r)))
    rt, ct = torch.as_tensor(rows), torch.as_tensor(cols)
    mg = tmg.multilevel_to_device(arr, st, "cpu")
    assert all(lv["P_csr"].n_cols == lv["Pt_csr"].n
               for lv in mg["levels"])
    y = tmg.multilevel_apply(mg, torch.as_tensor(K), ck.build_csr(rt, ct, n),
                             torch.as_tensor(r)).numpy()
    assert y.dtype == np.float64
    assert np.abs(y - y_j).max() <= tol * np.abs(y_j).max()


def _contraction(nys):
    """The JAX test's stationary iteration x <- x + C(b - K x) on the
    port's hierarchy, 12 steps from x = 0: (errors, rate)."""
    args, _, (arr, st) = _hierarchy(nys)
    K, rows, cols, n, _ = args
    Ksp = sp.csc_matrix((K, (rows, cols)), shape=(n, n))
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n)
    b = Ksp @ x_true
    mg = tmg.multilevel_to_device(arr, st, "cpu")
    csr0 = ck.build_csr(torch.as_tensor(rows), torch.as_tensor(cols), n)
    K0 = torch.as_tensor(K)
    x = np.zeros(n)
    errs = []
    for _ in range(12):
        r = torch.as_tensor(b - Ksp @ x)
        x = x + tmg.multilevel_apply(mg, K0, csr0, r).numpy()
        errs.append(float(np.linalg.norm(x - x_true)))
    return errs, (errs[-1] / errs[2]) ** (1 / 9)


@pytest.mark.parametrize("nys,drop,bound", [((2, 1), 1e-4, 0.5),
                                            ((4, 2, 1), 1e-2, 0.65)])
def test_contraction_rates(nys, drop, bound):
    """The two- and three-level contraction of JAX tests/test_mg.py:94-122
    on the port: the error falls by ``drop`` in 12 cycles at a rate under
    ``bound``."""
    errs, rate = _contraction(nys)
    assert errs[-1] < drop * errs[0]
    assert rate < bound


def test_problem_flat_mg_matches_modal_and_oracle():
    """``Problem(precond="mg")`` on the JAX test's plate (``symm`` ny = 2:
    "auto" gives the flat layout, one coarse level) meets the port's
    modal engine at rtol 5e-5 and the refined splu at 1e-6; every lane
    converged; the coarsest inverse is the f64 rule's."""
    acc = pt.Accelerometer("AP1030")
    mat = pt.get_material(7920.0, "isotropic", **MAT)

    def make(**kw):
        geom = pt.Geometry("symm", acc, pt.GeometryParams(*GP), ny=2)
        return pt.Problem(geom, mat, acc, device="cpu", **kw)

    freqs = np.linspace(60.0, 400.0, 9)
    y_ref = make(engine="modal").solveForward(freqs).numpy()
    p = make(precond="mg")
    y = p.solveForward(freqs).numpy()
    assert p._tier == ("flat", "mg", False)
    assert p._mg_static["n"] == (p.n_free, _plate(1)[0].n_free)
    np.testing.assert_allclose(y, y_ref, rtol=5e-5)
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))
    assert bool(np.all(p.diagnoseSweep(freqs[::4])["converged"]))


def test_rectangular_products_match_scipy():
    """The plain K3 (``scatter_mv`` and ``csr_mv`` on a rectangular plan)
    applies P (1386 x 420) and P^T (the swapped pattern over the same
    data) as scipy does, to 1e-14 of max |y|, for one and several lanes;
    each plan's CSR copy, which the CUDA kernels read, is scipy's CSR of
    the matrix."""
    (P,) = _chain((2, 1))
    P = P.tocoo()
    rows, cols = torch.as_tensor(P.row.astype(np.int64)), \
        torch.as_tensor(P.col.astype(np.int64))
    data = torch.as_tensor(P.data)[None]
    rng = np.random.default_rng(1)
    for A, r, c, plan in ((P, rows, cols, ck.build_csr(rows, cols, *P.shape)),
                          (P.T, cols, rows,
                           ck.build_csr(cols, rows, P.shape[1], P.shape[0]))):
        assert (plan.n, plan.n_cols) == A.shape
        # the kernels' CSR copy: scipy's CSR of the matrix, the data read
        # through the permutation
        Ac = sp.csr_matrix(A)
        Ac.sort_indices()
        np.testing.assert_array_equal(plan.rowptr.numpy(), Ac.indptr)
        np.testing.assert_array_equal(plan.col.numpy(), Ac.indices)
        d = data[0] if plan.perm is None else data[0, plan.perm.long()]
        np.testing.assert_array_equal(d.numpy(), Ac.data)
        for lanes in ((), (5,)):
            x = rng.standard_normal(lanes + (A.shape[1],))
            ref = (A @ x.T).T
            tol = 1e-14 * np.abs(ref).max()
            y = ck.scatter_mv(data, torch.as_tensor(x), r, c, A.shape[0])[0]
            assert np.abs(y.numpy() - ref).max() <= tol
            y = ck.csr_mv(data, torch.as_tensor(x), plan)[0]
            assert np.abs(y.numpy() - ref).max() <= tol
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.csr_mv(data, torch.zeros(P.shape[0], dtype=torch.float64),
                  ck.build_csr(rows, cols, *P.shape))
