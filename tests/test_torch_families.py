"""The port's material families and pure-bending path through the mixed
engine (plate_inverse_problem_tpu_torch), held against the JAX package on
the CPU.

Three JAX mixed-engine compiles, module-scoped, on the small plate of
tests/test_problem.py (the ``symm`` template, ny = 1): a SOL 45 degree cut
and ``OrthotropicD4`` on the 3-field path (n = 420), isotropic steel on the
pure-bending path (n = 270).  The port runs on the JAX operator data
(``opdata_from_jax``, one band basis): ``solveForward`` to 3e-6 of the JAX
FRF's max (the f32 preconditioner rounds differently on the two sides, as
in tests/test_torch_problem.py), both within 1e-6 of the host f64
``splu``; the port's own operator data equal to JAX's but the band basis
and the dense inverse.  ``OrthotropicD4``'s JAX forward FRF comes from its
one compile, the scaled log_afc r + J at theta_0 (fr = |ref| exp(r)); r
to 3e-6, J to 1e-5 of max |J| (as tests/test_torch_inverse.py).  Also:
``mixed_apply`` with K_im as a third operator (1e-13 of each row's
abs-sum, f64 summation order), the band-panel product ``_dd_spmv``
(within one ulp of exact rational sums of its f64 terms), the losses
of the complex pure-bending FRF (1e-5) and its Jacobian against the
gradient (1e-8), ``getSolutionMatrices``.
"""
import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops import mixed as jmixed
from plate_inverse_problem_tpu_torch.ops import mixed as tmixed
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = 2e-3
GP_SYMM = (100e-3, 20e-3, 2e-3, 10e-3, None)   # tests/test_problem.py
FREQS = np.linspace(40.0, 500.0, 8)

# the engine cases: (atype, moduli, density, accelerometer on the Problem)
CASES = {
    "sol45": ("sol", dict(E1=120e9, E2=8.5e9, G12=4.5e9, nu12=0.30,
                          beta=0.006, angles=(45.0,)), 1550.0, True),
    "d4": ("orthotropic_d4", dict(E1=210e9, E2=200e9, G12=75e9, nu12=0.33,
                                  b1=0.003, b2=0.003, b3=0.004, b4=0.0),
           7920.0, True),
    "symm": ("isotropic", dict(E=200e9, G=75e9, beta=0.003), 7920.0, False),
}
D4_START = np.array([1.02, 0.98, 1.03, 0.97, 1.1, 0.9, 1.05, 1.0])


def _parts(mod, case):
    atype, kw, rho, with_acc = CASES[case]
    acc = mod.Accelerometer("AP1030")
    geom = mod.Geometry("symm", acc, mod.GeometryParams(*GP_SYMM), ny=1)
    return geom, mod.get_material(rho, atype, **kw), (acc if with_acc
                                                       else None)


@pytest.fixture(scope="module")
def engine():
    """For each case the JAX Problem, its opdata, the port Problem on it,
    and the JAX output of the case's one compile: the FRF at the truth
    (sol45, symm) or the scaled log_afc r + J at theta_0 against the splu
    FRF at the truth (d4)."""
    out = {}
    for case in CASES:
        pj = pip.Problem(*_parts(pip, case), engine="mixed")
        od = pj.getFRCore()[1]
        pp = pt.Problem(*_parts(pt, case), device="cpu",
                        opdata=pt.opdata_from_jax(od, "cpu"))
        truth = np.asarray(pp.parameters)
        rec = {"pj": pj, "od": od, "pp": pp, "truth": truth}
        if case == "d4":
            ref = splu_frf(pp, FREQS)
            th0 = truth * D4_START
            rf = pj.getResidualFunction(FREQS, ref, kind="log_afc",
                                        scaling_params=th0)
            r, J = (np.asarray(a) for a in rf.value_and_jac(
                np.ones(truth.size)))
            rec |= {"ref": ref, "th0": th0, "rJ": (r, J),
                    "y": np.abs(ref) * np.exp(r)}
        else:
            rec["y"] = np.asarray(pj.getFRFunction()(FREQS, truth))
        out[case] = rec
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_forward_matches_jax_and_oracle(engine, case):
    e = engine[case]
    pp = e["pp"]
    assert pp.is_symmetric_path == (case == "symm")
    assert pp.n_free == e["pj"].n_free == (270 if case == "symm" else 420)
    th = e.get("th0", e["truth"])
    y = pp.solveForward(FREQS, th)
    assert y.shape == (FREQS.size,)
    assert y.dtype == (torch.complex128 if case == "symm" else torch.float64)
    y = y.numpy()
    assert np.abs(y - e["y"]).max() / np.abs(e["y"]).max() <= 3e-6
    ref = splu_frf(pp, FREQS, th)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))
    assert np.all(np.abs(e["y"] - ref) <= 1e-6 * np.abs(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_opdata_equals_jax(engine, case):
    """The port's own operator data equals the JAX opdata, except the band
    basis (ARPACK's random start vector) and the dense inverse (the port's
    is f64: ops/dense.py); ``opdata_from_jax`` took the JAX pytree with its
    ``trc`` constants as it is."""
    e = engine[case]
    pj = e["pj"]
    pp = pt.Problem(*_parts(pt, case), device="cpu")
    ot = pp.getFRCore()[1]
    conv = e["pp"].getFRCore()[1]
    assert "trc" in e["od"] and "trc" not in conv
    assert set(ot) - {"invK64"} == set(conv) - {"invK32", "Kref32"}
    for k in set(ot) & set(conv) - {"W64"}:
        assert ot[k].dtype == conv[k].dtype, k
        np.testing.assert_array_equal(ot[k].numpy(), conv[k].numpy(), k)
    np.testing.assert_array_equal(pp._reference_stiffness_flat(),
                                  pj._reference_stiffness_flat())
    np.testing.assert_array_equal(pp._eq_scale, pj._eq_scale)
    np.testing.assert_array_equal(pp.MInertia, pj.MInertia)
    np.testing.assert_array_equal(pp.fInertia, pj.fInertia)
    y = pp.solveForward(FREQS).numpy()
    ref = splu_frf(pp, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))


def test_d4_residual_jacobian_matches_jax(engine):
    e = engine["d4"]
    rf = e["pp"].getResidualFunction(FREQS, e["ref"], kind="log_afc",
                                     scaling_params=e["th0"])
    r, J = (a.numpy() for a in rf.value_and_jac(np.ones(e["truth"].size)))
    rj, Jj = e["rJ"]
    assert J.shape == (FREQS.size, 8)
    assert np.abs(r - rj).max() <= 3e-6
    assert np.abs(J - Jj).max() <= 1e-5 * np.abs(Jj).max()


def test_mixed_apply_per_modulus_matches_jax(engine):
    """A(theta) U - the residual map of the adjoint Jacobian - with K_im a
    third operator, against the JAX ``mixed_apply`` on the same data."""
    e = engine["d4"]
    od, pp = e["od"], e["pp"]
    th = torch.as_tensor(e["th0"])
    (Are, Aim), (Bre, Bim), (Dre, Dim) = pp.material.abd_split(th, H)
    ABD = np.asarray(od["ABD"])
    K_re = np.einsum("mk,mkn->n", torch.stack([Are, Bre, Dre]).numpy(), ABD)
    K_im = np.einsum("mk,mkn->n", torch.stack([Aim, Bim, Dim]).numpy(), ABD)
    rng = np.random.default_rng(2)
    U_re, U_im = rng.standard_normal((2, FREQS.size, pp.n_free))
    om = 2.0 * np.pi * FREQS
    M, rows, cols = (np.array(od[k]) for k in ("MIn", "rows", "cols"))
    t = [torch.as_tensor(a) for a in (K_re, K_im, M, om, U_re, U_im, rows,
                                      cols)]
    out_t = tmixed.mixed_apply(*t, pp.n_free, ki_proportional=False)
    out_j = jmixed.mixed_apply(K_re, K_im, M, om, U_re, U_im, rows, cols,
                               pp.n_free, ki_proportional=False)
    Ab = (np.abs(K_re) + np.abs(K_im) + om.max() ** 2 * np.abs(M))
    bound = np.zeros(pp.n_free)
    np.add.at(bound, rows, Ab * np.abs(U_re + 1j * U_im).max(0)[cols])
    for a, b in zip(out_t, out_j):
        assert np.all(np.abs(a.numpy() - np.asarray(b)) <= 1e-13 * bound)


def test_dd_spmv_exact_under_cancellation():
    """The band panels' row sums: rows whose terms cancel to 1e-12 of their
    size come out within one ulp of the exact sum of the f64 terms (against
    rational arithmetic), where one f64 ``index_add_`` pass is off by far
    more."""
    from fractions import Fraction

    rng = np.random.default_rng(8)
    n, deg = 50, 24
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    x = rng.standard_normal((3, n))
    data = rng.standard_normal(rows.size) * 10.0 ** rng.integers(-3, 4,
                                                               rows.size)
    # the last entry of each row cancels the others to ~1e-12 of them
    terms = data * x[0][cols]
    last = np.arange(deg - 1, rows.size, deg)
    part = np.add.reduceat(terms, np.arange(0, rows.size, deg)) - terms[last]
    data[last] = -(part * (1.0 + 1e-12)) / x[0][cols[last]]
    t = [torch.as_tensor(a) for a in (data, x, rows, cols)]
    out = tmixed._dd_spmv(t[0][None], t[1], t[2], t[3], n)[0].numpy()
    exact = np.zeros((3, n))
    for k in range(3):
        acc = [Fraction(0)] * n
        for j in range(rows.size):
            acc[rows[j]] += Fraction(data[j]) * Fraction(x[k, cols[j]])
        exact[k] = [float(v) for v in acc]
    assert np.all(np.abs(out - exact) <= np.spacing(np.abs(exact)))
    plain = np.zeros((3, n))
    np.add.at(plain.T, rows, data[:, None] * x.T[cols])
    assert (np.abs(plain[0] - exact[0]) / np.abs(exact[0])).max() > 1e-6


def test_symmetric_path_losses(engine):
    """The pure-bending FRF is complex: every loss reads its real and
    imaginary parts against a complex reference (values against the JAX
    FRF in numpy, 1e-5 relative), and 2 J^T r / m of the log_afc residual
    equals the MSE_LOG_AFC gradient to 1e-8 of its max (both through the
    pure-bending adjoint hooks)."""
    e = engine["symm"]
    pp, yj, truth = e["pp"], e["y"], e["truth"]
    rng = np.random.default_rng(4)
    ref = yj * (1.0 + 0.05 * (rng.standard_normal(FREQS.size)
                              + 1j * rng.standard_normal(FREQS.size)))
    terms = {"MSE": np.abs(yj - ref) ** 2,
             "RMSE": np.abs(yj - ref) ** 2 / np.abs(ref) ** 2,
             "MSE_AFC": (np.abs(yj) - np.abs(ref)) ** 2,
             "MSE_LOG_AFC": (np.log(np.abs(yj)) - np.log(np.abs(ref))) ** 2}
    for ft, term in terms.items():
        v = float(pp.getLossFunction(FREQS, ref, ft)(truth))
        assert abs(v - term.mean()) <= 1e-5 * term.mean(), ft
    th0 = truth * np.array([1.03, 0.98, 1.2])
    r, J = (a.numpy() for a in pp.getResidualFunction(
        FREQS, ref, kind="log_afc").value_and_jac(th0))
    g = pp.getLossFunction(FREQS, ref, "MSE_LOG_AFC").grad(th0).numpy()
    assert np.abs(2.0 * J.T @ r / r.size - g).max() <= 1e-8 * np.abs(g).max()


def test_get_solution_matrices_match_jax(engine):
    e = engine["symm"]
    D = np.random.default_rng(6).uniform(1.0, 2.0, 6)
    for a, b in zip(e["pp"].getSolutionMatrices(D, 0.01),
                    e["pj"].getSolutionMatrices(D, 0.01)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * np.abs(np.asarray(b)).max())
