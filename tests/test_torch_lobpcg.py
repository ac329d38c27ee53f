"""The port's LOBPCG band basis (plate_inverse_problem_tpu_torch/ops/
lobpcg.py; ``Problem(basis="lobpcg")``) held against the JAX package's
``ops/lobpcg.py`` on the CPU.

* ``lobpcg_pencil`` on the JAX test's synthetic pencil (n = 400, 1e8
  spectral spread, the same start block and the same f32 inverse in the
  GCR T, ``gcr_T``):
  eigenvalues to 1e-8 relative of the JAX function's (both converge to
  relres 1e-6, so their Ritz values differ at ~relres^2) and the spans'
  principal angles to 1 - 1e-8, M-orthonormal to 1e-10.
* ``band_basis_lobpcg`` on the ``sh_i`` ny = 2 pencil (n = 1466) with the
  port's dense f64 T against the JAX function (its f32 T) and the port's
  ARPACK basis: eigenvalues to 1e-6 relative and spans to 1 - 1e-6 (the
  JAX test's bounds against ARPACK).
* ``Problem(basis="lobpcg")`` on the dense tier (n = 1466) and on the
  forced band + two-grid tier (``sh_i`` ny = 4, n = 5428) against the
  port's refined splu oracle, 1e-6 and 1e-5 (the JAX tests' bounds); two
  fresh Problems give the same basis bits; the flat multilevel tier warns
  and takes the ARPACK basis, as the JAX package does.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.fem.assembly import MODULI_INDICES
from plate_inverse_problem_tpu.ops import lobpcg as jlob
from plate_inverse_problem_tpu_torch.ops import lobpcg as tlob
from plate_inverse_problem_tpu_torch.ops.dense import inv_refined
from plate_inverse_problem_tpu_torch.ops.mixed import (
    _dense_apply, band_basis_host)
from plate_inverse_problem_tpu_torch.ops.scatter import to_dense
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)
MAT = dict(E=200e9, G=75e9, beta=0.003)
OM_MAX = 2 * np.pi * 600.0


def _sh_i(ny, **kw):
    acc = pt.Accelerometer("AP1030")
    geom = pt.Geometry("sh_i", acc, pt.GeometryParams(*GP), ny=ny)
    mat = pt.get_material(7920.0, "isotropic", **MAT)
    return pt.Problem(geom, mat, acc, device="cpu", **kw)


def _m_angles(W1, W2, M):
    """Cosines of the principal angles between two M-orthonormal bases."""
    return np.linalg.svd(W1.T @ (M @ W2), compute_uv=False)


def test_lobpcg_pencil_synthetic_matches_jax():
    rng = np.random.default_rng(0)
    n, m = 400, 16
    d = np.logspace(0, 8, n)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    K = (Q * d) @ Q.T
    K = 0.5 * (K + K.T)
    M = np.diag(rng.uniform(0.5, 2.0, n))
    rows, cols = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n),
                                                 indexing="ij"))
    invK32 = np.linalg.inv(K).astype(np.float32)
    X0 = rng.standard_normal((m + 8, n))

    applies = jlob._make_applies(n, band=None,
                                 precond={"kind": "dense", "refine": 4})
    opd = {"K64": jnp.asarray(K.ravel()), "M64": jnp.asarray(M.ravel()),
           "rows": jnp.asarray(rows), "cols": jnp.asarray(cols),
           "invK32": jnp.asarray(invK32)}
    X0j = np.asarray(jax.jit(applies[1])(opd, jnp.asarray(X0)))
    lam_j, X_j, _, it_j = jlob.lobpcg_pencil(*applies, opd, X0j, n_wanted=m,
                                             tol=1e-6, maxiter=60)

    # the pencil is dense (rows of 400 columns: more than a K3 tile holds),
    # so its products are dense GEMMs here; T is the port's GCR around the
    # dense f32 inverse, as in the JAX test
    Kt, Mt = torch.as_tensor(K), torch.as_tensor(M)
    invK = torch.as_tensor(invK32)

    def apply_KM(U):
        return U @ Kt, U @ Mt

    apply_T = tlob.gcr_T(lambda U: U @ Kt,
                         lambda x: _dense_apply(invK, x).double(), 4)
    lam, X, relres, it = tlob.lobpcg_pencil(
        apply_KM, apply_T, apply_T(torch.as_tensor(X0)), n_wanted=m,
        tol=1e-6, maxiter=60)
    lam, X = lam.numpy(), X.numpy()
    assert it < 60 and it_j < 60 and float(relres[:m].max()) < 1e-6
    np.testing.assert_allclose(lam[:m], lam_j[:m], rtol=1e-8)
    assert np.abs(X[:m] @ M @ X[:m].T - np.eye(m)).max() < 1e-10
    assert _m_angles(X[:m].T, X_j[:m].T, M).min() > 1.0 - 1e-8


@pytest.fixture(scope="module")
def plate_pencil():
    """The equilibrated ``sh_i`` ny = 2 pencil (the JAX test's
    ``plate_pencil``, on the port's host layer, which equals the JAX
    package's) and the JAX package's basis of it with its dense f32 T."""
    from plate_inverse_problem_tpu.ops.dense import inv_refined as jinv
    from plate_inverse_problem_tpu.ops.scatter import to_dense as jdense

    p = _sh_i(2)
    op, n, mat = p.op, p.n_free, p.material
    (Ar, _), (Br, _), (Dr, _) = mat.abd_split(torch.as_tensor(p.parameters),
                                              2e-3)
    K_flat = sum(float(Ar[i]) * op.mats["A" + s]
                 + float(Br[i]) * op.mats["B" + s]
                 + float(Dr[i]) * op.mats["D" + s]
                 for i, s in enumerate(MODULI_INDICES))
    rows, cols = op.pattern.rows, op.pattern.cols
    dvals = np.zeros(n)
    dmask = rows == cols
    np.add.at(dvals, rows[dmask], np.abs(K_flat[dmask]))
    s_eq = 1.0 / np.sqrt(np.where(dvals > 0, dvals, 1.0))
    ss = s_eq[rows] * s_eq[cols]
    K, M = K_flat * ss, p.MInertia * ss
    invK32 = jax.jit(lambda d, r, c: jinv(jdense(d, r, c, n)))(
        jnp.asarray(K, jnp.float32), jnp.asarray(rows), jnp.asarray(cols))
    W_j, lam_j = jlob.band_basis_lobpcg(
        K, M, rows, cols, n, OM_MAX,
        precond={"kind": "dense", "invK32": invK32, "refine": 8})
    Msp = sp.csr_matrix((M, (rows, cols)), shape=(n, n))
    return dict(n=n, rows=rows, cols=cols, K=K, M=M, W_j=W_j, lam_j=lam_j,
                Msp=0.5 * (Msp + Msp.T))


def test_band_basis_lobpcg_matches_jax_and_arpack(plate_pencil):
    d = plate_pencil
    n, rows, cols = d["n"], d["rows"], d["cols"]
    rt, ct = torch.as_tensor(rows), torch.as_tensor(cols)
    invK = inv_refined(to_dense(torch.as_tensor(d["K"]), rt, ct, n))
    W, lam = tlob.band_basis_lobpcg(
        d["K"], d["M"], rows, cols, n, OM_MAX,
        precond={"kind": "dense", "invK": invK, "refine": 8})
    W, lam = W.numpy(), lam.numpy()
    assert tlob.band_basis_lobpcg.rounds[-1][0] == W.shape[1]
    W_a, lam_a = band_basis_host(d["K"], d["M"], rows, cols, n,
                                 omega_max=OM_MAX)
    for W_ref, lam_ref in ((d["W_j"], d["lam_j"]), (W_a, lam_a)):
        m = min(W.shape[1], W_ref.shape[1])
        np.testing.assert_allclose(lam[:m], lam_ref[:m], rtol=1e-6)
        assert _m_angles(W[:, :m], W_ref[:, :m], d["Msp"]).min() > 1 - 1e-6
    assert W.shape[1] == d["W_j"].shape[1]


def test_problem_lobpcg_dense_tier_frf_and_bits():
    """The dense tier (n = 1466, flat + dense): the FRF at 16 points over
    40-600 Hz within 1e-6 of the refined splu; a second fresh Problem's
    basis has the same bits."""
    freqs = np.linspace(40.0, 600.0, 16)
    p = _sh_i(2, basis="lobpcg")
    y = p.solveForward(freqs).numpy()
    assert p._tier[:2] == ("flat", "dense") and p._basis_resolved == "lobpcg"
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))
    q = _sh_i(2, basis="lobpcg")
    assert torch.equal(p.getFRCore()[1]["W64"], q.getFRCore()[1]["W64"])


def test_problem_lobpcg_band_twogrid_tier_frf():
    """basis='lobpcg' through the forced band layout + two-grid (T: the
    two-grid cycle with its band matvec) at n = 5428, 8 points, within
    1e-5 of the refined splu (the JAX test's bound)."""
    freqs = np.linspace(40.0, 600.0, 8)
    p = _sh_i(4, basis="lobpcg", operator_layout="band", precond="mg")
    y = p.solveForward(freqs).numpy()
    assert p._tier[:2] == ("band", "mg") and p._basis_resolved == "lobpcg"
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-5 * np.abs(ref))


def test_lobpcg_on_flat_mg_warns_and_takes_arpack():
    """The JAX package's semantics: LOBPCG is not wired for the flat
    multilevel tier; the Problem warns, builds the ARPACK basis, and its
    FRF meets the refined splu at 1e-6."""
    freqs = np.linspace(60.0, 420.0, 4)
    p = _sh_i(2, basis="lobpcg", precond="mg")
    with pytest.warns(RuntimeWarning, match="not wired"):
        y = p.solveForward(freqs).numpy()
    assert p._tier[:2] == ("flat", "mg") and p._basis_resolved == "arpack"
    ref = splu_frf(p, freqs)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))
