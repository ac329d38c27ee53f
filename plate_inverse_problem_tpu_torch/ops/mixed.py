"""Mixed-precision frequency sweep: f64-grade FRFs, f32 two-grid work.

Port of the JAX package's ``ops/mixed.py`` for its tiers: the exact f64
operator on the flat pattern (K3, the CSR kernel of ops/csr_kernel.py) or
in the RCM block-tridiagonal layout, preconditioned by the dense inverse
of the reference stiffness (n <= 12288; f64 in the port, ops/dense.py), by
the band f32 two-grid cycle, or on the flat layout by the f32 multilevel
cycle (ops/mg.py).

1. **Band basis** (init-time): the lowest ``m`` M-orthonormal modes of
   the equilibrated reference pencil, from ARPACK shift-invert in f64 on
   the host (``band_basis_host``), or factorization-free by LOBPCG on the
   device (ops/lobpcg.py, ``Problem(basis="lobpcg")``).
2. **Per-theta Rayleigh-Ritz in f64** on the device: band eigenpairs with a
   Rayleigh-quotient refinement, and the exactly projected m x m pencil.
3. **Per-frequency solve**: exact band-resolvent start, then restarted
   flexible GMRES in split-complex f64 preconditioned by the band resolvent
   plus the deflated complement preconditioner (dense inverse or two-grid
   cycle), then final band corrections on the band projection of the true
   residual, Z^T (b - A x) = Z^T b - (A Z)^T x.  The Krylov bases are f64
   on every tier (the JAX package stores them in f32 on its dense tier,
   which off the build point left lanes 1.5e-6 to 2.1e-6 off an f64 LU
   solve on the SOL 45 deg plate at n = 1466, tests/test_torch_diag.py).
   A lane that is still unconverged when its budget is spent (true
   residual above its target and less than 9 orders of magnitude below
   its start, the rule of ``diagnoseSweep``) gets the budget again, its
   own lanes only; the JAX package stops there.

The final band corrections are where the port departs from the JAX
package, which feeds them a full residual b - A x computed in f64 with
the operator values combined entrywise.  At a resonance peak the solution
is dominated by one smooth band mode, and the f64 rounding of A x there is
eps * sum_k |A_jk x_k|, which exceeds |A x| by the stiffness spread
lambda_max / lambda_mode; the resolvent amplifies it by the modal Q into
the FRF.  Measured against an f64 LU solve with extended-precision
iterative refinement (.probes/peak_floor.py, NVIDIA H100 80GB HBM3 at
700 W): 2.1e-6-3.1e-6 at the pure-bending peak (n = 13862) and up to
6.3e-7 at the 21k laminate peak, varying from run to run with the f64
atomics of the scatter that ran then.  The port computes the band panels
K Z, M Z (and K_im Z) once per sweep with exact row sums (``_dd_spmv``:
exact products, Rump's extraction), rounded once, and takes the projected
residual from them with f64 dots, whose rounding no longer meets the
stiffness spread: 3.2e-7 at that peak, the same in every run.

The imaginary stiffness is exact in every operator apply: for the
scalar-loss material families K_im = beta K_re, and the applies scale the
K_re matvec; for per-modulus loss factors (``ki_proportional=False``)
K_im is a third operator beside K_re and M.  beta = <K_re, K_im> /
<K_re, K_re> is only the preconditioner's model of it.

The JAX side vmaps the per-frequency solve; here the frequency lanes are a
written-out leading axis of every (lanes, 2, n) re/im stack.  Its batched
``while_loop``s freeze each lane once the lane's own condition fails; the
port keeps one step counter and a per-lane ``active`` mask, applies every
state update through ``torch.where`` and ends a loop when no lane is active
(one host sync per step).  Each lane therefore follows exactly the
iteration it would follow alone.
"""
from __future__ import annotations

import numpy as np
import torch

from .band import band_mv, flat_to_band
from .band_kernel import band_mv_f32
from .csr_kernel import build_csr, csr_apply, csr_mv
from .dense import dense_apply as _dense_apply
from .mg import multilevel_apply, twogrid_apply

# f32 refinement rounds around the two-grid / multilevel cycle (each round
# costs one extra f32 fine matvec + cycle and squares the cycle's error)
_MG_REFINE = 1
# refinement rounds inside the dense preconditioner when it is the JAX
# package's f32 inverse (each costs one extra GEMM + f32 SpMV and squares
# the eps32 * kappa error of the inverse; the JAX package tuned 1)
_PRECOND_REFINE = 1
# the residual-map apply (mixed_apply) walks the nnz axis in segments of
# _RES_SEG entries and the lanes in chunks that keep each segment's
# (S, 2, lanes, seg) f64 contribution tensor under _APPLY_BUDGET bytes (S =
# 2 operators, K and M, or 3 with K_im);
# the sweep's flat applies walk it in _RES_SEG segments above 2 * _RES_SEG.
# Sized for an 80 GB card: 64-lane chunks at the 21k tier, and the
# Jacobian's 3 forward tangents keep about 4x that live (5.2 GB peak with
# the sweep's state, H100).  Module-level so the CPU tests can shrink both
# to walk several chunks and segments on a small mesh.
_RES_SEG = 1 << 17
_APPLY_BUDGET = 512e6
# rows of the band basis per exact panel product (_dd_spmv)
_DD_ROWS = 16
# seed of band_basis_host's ARPACK start vector
_BASIS_SEED = 0


# ---------------------------------------------------------------------------
# host-side band basis (init time)
# ---------------------------------------------------------------------------

def band_basis_host(K_flat_ref: np.ndarray, M_flat: np.ndarray,
                    rows: np.ndarray, cols: np.ndarray, n: int,
                    omega_max: float, margin: float = 2.5,
                    m_min: int = 16, m_max: int = 256):
    """Lowest-band M-orthonormal modes of the (equilibrated) reference pencil.

    Returns (W (n, m) f64, lam_ref (m,)).  Computed once per Problem with
    ARPACK shift-invert on the host, from a fixed start vector (seeded
    normal entries; ARPACK's own start moves from call to call): the same
    pencil gives the same basis in every Problem and every process, and so
    the same sweeps, derivatives and optimizer paths.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    K = sp.csc_matrix((K_flat_ref, (rows, cols)), shape=(n, n))
    M = sp.csc_matrix((M_flat, (rows, cols)), shape=(n, n))
    K = 0.5 * (K + K.T)
    M = 0.5 * (M + M.T)

    target = (margin * omega_max) ** 2
    m = min(m_max, max(m_min, 8), n - 2)
    v0 = np.random.default_rng(_BASIS_SEED).standard_normal(n)
    lam = W = None
    while True:
        lam, W = spla.eigsh(K, k=m, M=M, sigma=0, which="LM", v0=v0)
        order = np.argsort(lam)
        lam, W = lam[order], W[:, order]
        if lam[-1] >= target or m >= min(m_max, n - 2):
            break
        m = min(m * 2, m_max, n - 2)

    # keep modes up to the margin (but at least m_min)
    keep = max(int(np.searchsorted(lam, target)) + 1, m_min)
    keep = min(keep, lam.size)
    lam, W = lam[:keep], W[:, :keep]

    # M-orthonormalize exactly (ARPACK returns M-orthonormal up to tol)
    G = W.T @ (M @ W)
    L = np.linalg.cholesky(0.5 * (G + G.T))
    W = np.linalg.solve(L, W.T).T
    return np.ascontiguousarray(W), lam


def static_preconditioner_host(K_flat_ref: np.ndarray, rows: np.ndarray,
                               cols: np.ndarray, n: int) -> np.ndarray:
    """Dense inverse (n, n) of the symmetric part of the equilibrated
    reference stiffness (JAX ``ops/mixed.py`` ``static_preconditioner_host``),
    the dense tier's complement preconditioner.  Differs from the JAX
    function: f64 (``dense.inv_refined``, the port's rule for dense
    inverses, ops/dense.py), where the JAX one returns its f32 downcast;
    computed with torch on the host."""
    from .dense import inv_refined
    from .scatter import to_dense

    K = to_dense(torch.as_tensor(np.asarray(K_flat_ref, np.float64)),
                 torch.as_tensor(np.asarray(rows)).long(),
                 torch.as_tensor(np.asarray(cols)).long(), n)
    return np.ascontiguousarray(inv_refined(0.5 * (K + K.T)).numpy())


# ---------------------------------------------------------------------------
# batched split-complex flexible GMRES
# ---------------------------------------------------------------------------

def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _sel(mask, new, old):
    """Per-lane select: ``mask`` (L,) broadcast over the trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _pgmres(A_apply, P_apply, bb, x0, tol_rel, k_max: int, n_cycles: int,
            r0, band_correct, band_correct_n: int, basis_f32: bool = False,
            diag: bool = False, n_rescue: int = 0):
    """Restarted flexible (right-preconditioned) GMRES on split-complex f64
    lanes (JAX ``_pgmres`` with ``anchor=True``, ``tol_abs2=0``, a given
    start residual and final band corrections).

    ``bb``/``x0``/``r0``: (L, 2, n).  ``tol_rel``: (L,).  ``A_apply``/
    ``P_apply``/``band_correct``: (L', 2, n) -> (L', 2, n) maps taking a
    lane index (L',) as their second argument; ``band_correct`` maps an
    iterate to the iterate after one band correction.  Up to
    ``n_cycles`` cycles of ``k_max`` iterations; between cycles the TRUE
    f64 residual decides whether a lane goes on.  FLEXIBLE because the f32
    preconditioner is linear only to ~1e-7: the preconditioned vectors
    Z_j = P(v_j) are stored and x = x0 + Z y is exact for any P.

    ``basis_f32``: store the bases V and Z in f32 and run the CGS2 dots in
    f32; ``P_apply`` then takes and returns f32.  The operator applies, the
    iterates and the true residuals stay f64, so only the subspace's
    representation is f32: it caps one cycle's residual gain at ~3e-7 and
    the f64 restarts square that down (GMRES-IR).

    ``n_rescue``: up to that many more cycles for the lanes that are still
    unconverged by the diagnostics rule after ``n_cycles`` (residual above
    the target and above 1e-9 |r0|); a lane at its target, or whose target
    sits below the f64 floor after 9 orders of progress, stops.

    ``diag`` (JAX ``return_info``): also return, per lane, the TRUE f64
    residual norm the last cycle exited with, the residual norm of the
    returned iterate after the band corrections (one more operator apply),
    the initial residual norm |r0| and the residual target: (x, rn, rn_fin,
    rn0, tol).
    """
    L = bb.shape[0]
    lanes = torch.arange(L, device=bb.device)
    r0n2 = (r0 * r0).sum((1, 2))
    tol2 = (tol_rel * torch.sqrt(r0n2)) ** 2
    active = torch.ones(L, dtype=torch.bool, device=bb.device)
    x, r, rn2, tol2 = _pgmres_cycle(A_apply, P_apply, bb, x0, r0, tol2,
                                    tol_rel, k_max, True, active, lanes,
                                    basis_f32)
    c = 1
    while c < n_cycles + n_rescue:
        active = rn2 > tol2
        if c >= n_cycles:
            active = active & (rn2 > 1e-18 * r0n2)
        if not bool(active.any()):
            break
        if c < n_cycles:
            xn, rnew, rn2n, tol2n = _pgmres_cycle(
                A_apply, P_apply, bb, x, r, tol2, tol_rel, k_max, False,
                active, lanes, basis_f32)
            x, r = _sel(active, xn, x), _sel(active, rnew, r)
            rn2, tol2 = _sel(active, rn2n, rn2), _sel(active, tol2n, tol2)
        else:
            # a rescue cycle runs on its few lanes alone, compacted: its
            # bases and dots cost what those lanes need
            i = torch.nonzero(active).squeeze(1)
            x[i], r[i], rn2[i], tol2[i] = _pgmres_cycle(
                A_apply, P_apply, bb[i], x[i], r[i], tol2[i], tol_rel[i],
                k_max, False, torch.ones_like(i, dtype=torch.bool), lanes[i],
                basis_f32)
        c += 1

    # final defect corrections through the exact band resolvent, on the
    # band projection of the true residual (see mixed_sweep)
    for _ in range(band_correct_n):
        x = band_correct(x, lanes)
    if not diag:
        return x
    r_fin = bb - A_apply(x, lanes)
    return (x, torch.sqrt(rn2), torch.sqrt((r_fin * r_fin).sum((1, 2))),
            torch.sqrt(r0n2), torch.sqrt(tol2))


def _pgmres_cycle(A_apply, P_apply, bb, x_in, r0, tol2_in, tol_rel,
                  k_max: int, anchor: bool, run, lanes,
                  basis_f32: bool = False):
    """One FGMRES cycle over the lanes where ``run`` holds: Arnoldi with
    CGS2 orthogonalisation, incremental complex Givens rotations,
    back-substitution and reconstruction, then the TRUE f64 residual.

    Returns (x_new, r_new, rn2, tol2) for every lane; lanes outside ``run``
    come back unusable and the caller keeps their old state."""
    f64 = bb.dtype
    bd = torch.float32 if basis_f32 else f64      # basis storage
    dev = bb.device
    L, _, n = bb.shape
    tiny = 1e-300
    tinyb = 1e-30 if basis_f32 else tiny
    # relative residual gain one cycle can certify with this basis: the
    # estimate stops there and the f64 restart takes over
    floor = 3e-7 if basis_f32 else 1e-15

    beta0 = torch.sqrt((r0 * r0).sum((1, 2)))                    # (L,)
    V = torch.zeros(L, k_max + 1, 2, n, dtype=bd, device=dev)
    V[:, 0] = (r0 / torch.clamp(beta0, min=tiny)[:, None, None]).to(bd)
    Z = torch.zeros(L, k_max, 2, n, dtype=bd, device=dev)
    R = torch.zeros(L, k_max, k_max, 2, dtype=f64, device=dev)
    R[:, :, :, 0] = torch.eye(k_max, dtype=f64, device=dev)
    g = torch.zeros(L, k_max + 1, 2, dtype=f64, device=dev)
    g[:, 0, 0] = beta0
    cs = torch.ones(L, k_max, dtype=f64, device=dev)
    sn = torch.zeros(L, k_max, 2, dtype=f64, device=dev)
    floor2 = (floor * beta0) ** 2
    rn2 = beta0 * beta0
    tol2 = tol2_in.clone()
    j_fin = torch.zeros(L, dtype=torch.long, device=dev)

    def cdots(V, w):
        """Complex dots <V_k, w> for every basis row: (L, k+1) re, im."""
        t = torch.einsum("lkcn,ldn->lkcd", V, w)
        return t[..., 0, 0] + t[..., 1, 1], t[..., 0, 1] - t[..., 1, 0]

    def csaxpy(V, hre, him, w):
        """w - sum_k h_k V_k with complex coefficients h."""
        coef = torch.stack([torch.stack([hre, -him], dim=2),
                            torch.stack([him, hre], dim=2)], dim=2)
        return w - torch.einsum("lkcd,lkdn->lcn", coef, V)

    j = 0
    while j < k_max:
        active = run & (rn2 > torch.maximum(tol2, floor2))
        if not bool(active.any()):
            break
        j_fin = j_fin + active.long()
        idx = torch.nonzero(active).squeeze(1)
        # the operator and preconditioner run on the active lanes only
        z_a = P_apply(V[idx, j], lanes[idx])
        w_a = A_apply(z_a.to(f64), lanes[idx])
        z = torch.zeros(L, 2, n, dtype=bd, device=dev)
        w = torch.zeros(L, 2, n, dtype=bd, device=dev)
        z[idx] = z_a
        w[idx] = w_a.to(bd)
        Z[:, j] = _sel(active, z, Z[:, j])
        h1re, h1im = cdots(V, w)
        w = csaxpy(V, h1re, h1im, w)
        h2re, h2im = cdots(V, w)          # CGS2 reorthogonalisation
        w = csaxpy(V, h2re, h2im, w)
        hre = (h1re + h2re).to(f64)
        him = (h1im + h2im).to(f64)
        hl = torch.sqrt((w * w).sum((1, 2)))
        hlast = hl.to(f64)
        V[:, j + 1] = _sel(active, w / torch.clamp(hl, min=tinyb)[:, None, None],
                           V[:, j + 1])

        # apply the accumulated rotations to the new column (rotations
        # beyond the current step are the identity)
        zero = torch.zeros(L, 1, dtype=f64, device=dev)
        hre = torch.cat([hre, zero], dim=1)
        him = torch.cat([him, zero], dim=1)
        hre[:, j + 1] = hlast
        for i in range(k_max):
            a = (hre[:, i], him[:, i])
            b = (hre[:, i + 1], him[:, i + 1])
            s = (sn[:, i, 0], sn[:, i, 1])
            c_ = cs[:, i]
            top = _cmul((c_, 0.0 * c_), a)
            top = (top[0] + s[0] * b[0] - s[1] * b[1],
                   top[1] + s[0] * b[1] + s[1] * b[0])
            bot = _cmul((c_, 0.0 * c_), b)
            bot = (bot[0] - s[0] * a[0] - s[1] * a[1],
                   bot[1] - s[0] * a[1] + s[1] * a[0])
            hre[:, i], hre[:, i + 1] = top[0], bot[0]
            him[:, i], him[:, i + 1] = top[1], bot[1]

        # new rotation [[c, s], [-conj(s), c]] (c real) annihilating slot
        # j+1; degenerate a -> c = 0, s = phase of conj(b); both zero ->
        # identity
        a = (hre[:, j], him[:, j])
        b = (hre[:, j + 1], him[:, j + 1])
        amag = torch.sqrt(a[0] * a[0] + a[1] * a[1])
        bmag = torch.sqrt(b[0] * b[0] + b[1] * b[1])
        rho = torch.sqrt(amag * amag + bmag * bmag)
        a_ok = amag > tiny
        b_ok = bmag > tiny
        one = torch.ones_like(amag)
        zr = torch.zeros_like(amag)
        c = torch.where(a_ok, amag / torch.clamp(rho, min=tiny),
                        torch.where(b_ok, zr, one))
        phase = (torch.where(a_ok, a[0] / torch.clamp(amag, min=tiny), one),
                 torch.where(a_ok, a[1] / torch.clamp(amag, min=tiny), zr))
        denom = torch.where(a_ok, torch.clamp(rho, min=tiny),
                            torch.clamp(bmag, min=tiny))
        s = _cmul(phase, (b[0] / denom, -b[1] / denom))
        s = (torch.where(b_ok, s[0], zr), torch.where(b_ok, s[1], zr))
        cs[:, j] = torch.where(active, c, cs[:, j])
        sn[:, j] = _sel(active, torch.stack([s[0], s[1]], dim=1), sn[:, j])

        top = _cmul((c, 0.0 * c), a)
        top = (top[0] + s[0] * b[0] - s[1] * b[1],
               top[1] + s[0] * b[1] + s[1] * b[0])
        hre[:, j] = top[0]
        him[:, j] = top[1]
        R[:, :, j] = _sel(active, torch.stack([hre[:, :k_max],
                                               him[:, :k_max]], dim=2),
                          R[:, :, j])

        gj = (g[:, j, 0], g[:, j, 1])
        g_top = _cmul((c, 0.0 * c), gj)
        g_bot = (-(s[0] * gj[0] + s[1] * gj[1]),
                 -(s[0] * gj[1] - s[1] * gj[0]))
        g_new = g.clone()
        g_new[:, j, 0], g_new[:, j, 1] = g_top
        g_new[:, j + 1, 0], g_new[:, j + 1, 1] = g_bot
        g = _sel(active, g_new, g)
        rn2_new = g_bot[0] ** 2 + g_bot[1] ** 2
        rn2 = torch.where(active, rn2_new, rn2)
        # the first step resolves the stiffness-lift components of the
        # residual; the target is re-anchored at what is left after it
        if anchor and j == 0:
            anc = torch.maximum(torch.sqrt(rn2), 1e-13 * beta0)
            tol2 = torch.where(active, (tol_rel * anc) ** 2, tol2)
        j += 1

    # rows past a lane's last step: R is the identity there, g is masked to
    # zero so the back-substitution returns y = 0
    rows_on = torch.arange(k_max, device=dev)[None, :] < j_fin[:, None]
    g = torch.where(rows_on[..., None], g[:, :k_max], 0.0)
    y = torch.zeros(L, k_max, 2, dtype=f64, device=dev)
    for t in range(k_max):
        l = k_max - 1 - t
        acc_re = (R[:, l, :, 0] * y[..., 0]).sum(1) \
            - (R[:, l, :, 1] * y[..., 1]).sum(1)
        acc_im = (R[:, l, :, 0] * y[..., 1]).sum(1) \
            + (R[:, l, :, 1] * y[..., 0]).sum(1)
        num = (g[:, l, 0] - acc_re, g[:, l, 1] - acc_im)
        den = R[:, l, l, 0] ** 2 + R[:, l, l, 1] ** 2
        yl = _cmul(num, (R[:, l, l, 0] / torch.clamp(den, min=tiny),
                         -R[:, l, l, 1] / torch.clamp(den, min=tiny)))
        y[:, l, 0] = yl[0]
        y[:, l, 1] = yl[1]

    yb = y.to(bd)
    xc0 = torch.einsum("lk,lkn->ln", yb[..., 0], Z[:, :, 0]) \
        - torch.einsum("lk,lkn->ln", yb[..., 1], Z[:, :, 1])
    xc1 = torch.einsum("lk,lkn->ln", yb[..., 0], Z[:, :, 1]) \
        + torch.einsum("lk,lkn->ln", yb[..., 1], Z[:, :, 0])
    x = x_in + torch.stack([xc0, xc1], dim=1).to(f64)
    idx = torch.nonzero(run).squeeze(1)
    r_new = torch.zeros_like(bb)
    r_new[idx] = bb[idx] - A_apply(x[idx], lanes[idx])
    return x, r_new, (r_new * r_new).sum((1, 2)), tol2


# ---------------------------------------------------------------------------
# the mixed sweep
# ---------------------------------------------------------------------------

def _apply_chunk(n_ops: int, seg: int) -> int:
    """Lanes per residual-map pass: the largest power of two (8 at least)
    whose (n_ops, 2, lanes, seg) f64 contributions fit _APPLY_BUDGET."""
    chunk = max(8, int(_APPLY_BUDGET // (n_ops * 2 * seg * 8)))
    return 1 << (chunk.bit_length() - 1)


def mixed_apply(K_re, K_im, M_flat, omegas, U_re, U_im, rows, cols, n: int,
                ki_proportional: bool = True, csr=None):
    """Batched split-complex operator application A(theta) U on (F, n)
    pairs: the exact f64 operator of ``mixed_sweep`` on the flat pattern,
    one K3 pass (``csr_kernel.csr_apply`` on ``csr``, the pattern's CSR
    copy; built here when None) for the operator stack per chunk of lanes
    (_APPLY_BUDGET, which bounds the reverse mode's gathers): [K_re, M], or
    [K_re, M, K_im] for per-modulus loss factors
    (``ki_proportional=False``).

    With ``ki_proportional``, ``beta`` = <K_re, K_im> / <K_re, K_re> stays
    in the graph: its tangent d beta is what makes the adjoint Jacobian
    exact for the scalar-loss families (dK_im = d beta K_re + beta dK_re).
    Differentiable in the operator data by forward and reverse mode, at
    fixed U.

    Returns (AU_re, AU_im), each (F, n) f64.
    """
    f64 = torch.float64
    om2 = (omegas.to(f64) ** 2)[:, None]
    Kr = K_re.to(f64)
    ops = [Kr, M_flat.to(f64)]
    if not ki_proportional:
        ops.append(K_im.to(f64))
    uu = torch.stack([U_re.to(f64), U_im.to(f64)])
    if csr is None:
        csr = build_csr(rows, cols, n)
    seg = min(int(rows.shape[0]), _RES_SEG)
    chunk = _apply_chunk(len(ops), seg)
    data = torch.stack(ops)
    out = torch.cat([csr_apply(data, uu[:, lo:lo + chunk], csr, seg)
                     for lo in range(0, uu.shape[1], chunk)], dim=2)
    Kx, Mx = out[0], out[1]
    if ki_proportional:
        beta = torch.dot(Kr, K_im.to(f64)) / torch.dot(Kr, Kr)
        Kix = (beta * Kx[0], beta * Kx[1])
    else:
        Kix = out[2]
    return (Kx[0] - Kix[1] - om2 * Mx[0],
            Kx[1] + Kix[0] - om2 * Mx[1])


def _split(a):
    """Veltkamp split of a into 26-bit halves, a = hi + lo."""
    c = 134217729.0 * a          # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """a * b = p + e exactly (Dekker's TwoProduct; IEEE f64, no FMA
    contraction across torch ops)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _dd_spmv(data, x, rows, cols, n: int, csr=None):
    """Each operator of the (S, nnz) stack ``data`` on the pattern (rows,
    cols) — ``csr``, its CSR copy, built here when None — applied to the
    rows of x (m, n): (S, m, n) f64, every row sum exact
    before one final rounding however much its terms cancel.

    The products are split exactly, d x = p + e (TwoProduct).  Rump's
    extraction against sigma, a power of two above 2 * d_max * max_row |p|,
    splits p = p_hi + p_lo with every p_hi a multiple of ulp(sigma): any
    partial sum of a row's p_hi is then a representable multiple of it, so
    one row sum takes them exactly in any order, and the small p_lo + e
    sum alongside to f64 accuracy of their own size, both in one K3 pass
    (``csr_mv`` of the two stacks on x = 1: a fixed order, so the same bits
    in every run).  The result is S_hi + S_lo rounded once.  The rows of x
    go _DD_ROWS at a time."""
    if csr is None:
        csr = build_csr(rows, cols, n)
    ones = torch.ones(1, n, dtype=torch.float64, device=x.device)
    d_max = int(csr.rowptr.diff().max())
    lift = 2.0 ** (int(np.ceil(np.log2(d_max))) + 2)
    out = torch.empty(data.shape[0], x.shape[0], n, dtype=torch.float64,
                      device=x.device)
    for k in range(data.shape[0]):
        for lo_ in range(0, x.shape[0], _DD_ROWS):
            p, e = _two_prod(data[k], x[lo_:lo_ + _DD_ROWS][:, cols])
            idx = rows.expand_as(p)
            m_row = torch.zeros(p.shape[0], n, dtype=torch.float64,
                                device=x.device).scatter_reduce(
                1, idx, p.abs(), "amax")
            _, ex = torch.frexp(m_row)                  # m_row < 2^ex
            sigma = torch.ldexp(lift * torch.ones_like(m_row), ex)[:, rows]
            p_hi = (sigma + p) - sigma
            sums = csr_mv(torch.cat([p_hi, (p - p_hi) + e]), ones, csr)[:, 0]
            out[k, lo_:lo_ + _DD_ROWS] = sums[:p.shape[0]] + sums[p.shape[0]:]
    return out


def _flat_seg(nnz: int) -> int:
    """nnz segment of the sweep's flat applies: one pass up to 2 * _RES_SEG
    entries, _RES_SEG segments above (JAX ``_fused_mv``)."""
    return nnz if nnz <= 2 * _RES_SEG else _RES_SEG


def mixed_sweep(K_re, K_im, M_flat, B_re, B_im, omegas, rows, cols, n: int,
                W64, *, band=None, mg=None, invK=None, K_ref32=None,
                basis_f32: bool = False, n_refine: int = 16,
                refine_tol: float = 3e-7, freq_chunk: int | None = None,
                ki_proportional: bool = True, k_cycle: int | None = None,
                adjoint: bool = False, csr=None, diagnostics: bool = False):
    """f64-grade frequency sweep, split-complex interface.  Differs from
    the JAX ``mixed_sweep``: K and B come split (K_re, K_im, B_re, B_im),
    the preconditioner's data as keywords (``band``, ``mg``, ``invK``),
    and the result is (U_re, U_im).

    K_re/K_im/M_flat (nnz,) f64 flat operator data on the pattern
    (rows, cols); B_re/B_im (F, n) f64 right-hand sides; omegas (F,) f64;
    W64 (n, m) f64 M-orthonormal band basis.  ``freq_chunk``: lanes per
    batch; the frequencies are sorted by their band-computable resonance
    amplification first, so smooth chunks exit after few iterations.

    The tier is set by what is given:

    * ``band`` {"layout": BandLayout, "lin": (nnz,) int64 device scatter
      targets}: the exact operator runs as f64 block-tridiagonal GEMMs;
      without it, as K3 on the flat pattern (rows, cols);
    * ``mg``, the two-grid data {"tg_pack" (the f32 K_ref band packed by
      ops/band_kernel.pack_band_tiles), "dinv", "Pt", "Kc_inv", "slots",
      "lmax", "rl", "layout"} (band layout only): the complement
      preconditioner is the two-grid cycle; or the flat multilevel data
      {"multilevel" (ops/mg.multilevel_to_device), "Kref32" (nnz,) the
      f32 reference stiffness on the pattern}: the multilevel cycle, every
      product on K3 (the flat layout's, JAX ``ops/mixed.py:957-970``);
      either with ``_MG_REFINE`` f32 refinement rounds;
    * else ``invK`` (n, n), the dense inverse of the reference stiffness,
      applied as one GEMM in its own precision: f64, the port's (see
      ops/dense.py), or f32, the JAX package's, with ``_PRECOND_REFINE``
      f32 refinement rounds through ``K_ref32`` (nnz,) f32 on the pattern
      when that is given.

    ``basis_f32`` stores the FGMRES bases in f32 and feeds the
    preconditioner f32 (at least two cycles then: one cycle certifies only
    ~3e-7), as the JAX package does on its dense tier; the port keeps them
    in f64 by default, which on an H100 is no slower at n = 1466 and
    11910 and leaves fewer lanes unconverged (PERF.md).

    ``ki_proportional``: K_im = beta K_re exactly (the scalar-loss
    material families), so the applies scale the K_re matvec; else K_im is
    a third exact operator (per-modulus loss factors) in every apply, its
    Galerkin projection in the band solves, and beta only the
    preconditioner's model.

    ``adjoint``: solve conj(A) y = b instead of A u = b — the transpose of
    the real split-complex operator [[Ar, -Ai], [Ai, Ar]] of the complex
    symmetric A.  The same solver with the sign of the imaginary part
    flipped everywhere; the preconditioner (real, on Re K_ref) and the
    difficulty sort do not depend on the sign.

    ``csr``: the pattern's CSR copy (``csr_kernel.build_csr``; built here
    when None), on which K3 runs every flat operator apply and the row sums
    of the exact band panels.

    Returns (U_re, U_im), each (F, n) f64; with ``diagnostics`` (the JAX
    package's diagnostics path: the same solve) also the per-lane
    convergence signal of ``_pgmres``, (U_re, U_im, rn, rn_fin, rn0, tol),
    each norm (F,) in the units of b.
    """
    if mg is None and invK is None:
        raise ValueError("mixed_sweep needs a complement preconditioner: "
                         "the multigrid data ``mg`` or the dense ``invK``.")
    f64 = torch.float64
    f32 = torch.float32
    dev = K_re.device
    # beta is only the preconditioner's model of K_im; the residuals use
    # the exact K_im (= beta K_re for the scalar-loss families)
    beta = torch.dot(K_re, K_im) / torch.dot(K_re, K_re)
    Kr64 = K_re.to(f64)
    Ms64 = M_flat.to(f64)
    Ki64 = None if ki_proportional else K_im.to(f64)
    if csr is None:
        csr = build_csr(rows, cols, n)

    if band is not None:
        lay = band["layout"]
        bands = [flat_to_band(v, lay, band["lin"])
                 for v in (Kr64, Ms64, Ki64) if v is not None]

        def KM_mv(x):
            return band_mv(bands[0], x, lay), band_mv(bands[1], x, lay)

        def KMI_mv(uu):
            """(K u, M u, K_im u or None) for a (..., n) stack."""
            return (*KM_mv(uu),
                    None if ki_proportional else band_mv(bands[2], uu, lay))
    else:
        ops64 = torch.stack([v for v in (Kr64, Ms64, Ki64) if v is not None])
        seg = _flat_seg(csr.nnz)

        def KM_mv(x):
            out = csr_mv(ops64[:2], x, csr, seg)
            return out[0], out[1]

        def KMI_mv(uu):
            # K, M (and K_im) in one K3 pass over the pattern
            out = csr_mv(ops64, uu, csr, seg)
            return out[0], out[1], None if ki_proportional else out[2]

    # ---- per-theta band Rayleigh-Ritz, all f64 --------------------------
    KW, MW = KM_mv(W64.T.contiguous())                 # (m, n) rows = K w_i
    Kw = KW @ W64
    Mw = MW @ W64
    Kw = 0.5 * (Kw + Kw.T)
    Mw = 0.5 * (Mw + Mw.T)
    # first-order congruence correction for Mw = I + E:
    # C = K - (K E + E K)/2
    E = Mw - torch.eye(Mw.shape[0], dtype=f64, device=dev)
    Cw = Kw - 0.5 * (Kw @ E + E @ Kw)
    Cw_sym = 0.5 * (Cw + Cw.T)
    lam_w, Qw = torch.linalg.eigh(Cw_sym)
    # Rayleigh-quotient refinement of the Ritz values (one (m, m) GEMM)
    CQ = Cw_sym @ Qw
    lam_w = (Qw * CQ).sum(0) / (Qw * Qw).sum(0)
    Zw64 = W64 @ Qw                                    # (n, m) band modes
    # the band panels K Zw, M Zw (and K_im Zw), each entry f64-accurate in
    # its own magnitude (exact row sums, _dd_spmv): the resolvent start's
    # A x0 and the projected residuals of the final band corrections are
    # f64 dots against them
    panels = _dd_spmv(torch.stack([v for v in (Kr64, Ms64, Ki64)
                                   if v is not None]),
                      Zw64.T.contiguous(), csr.rows, csr.cols, n, csr)
    KZw64, MZ64 = panels[0].T, panels[1].T             # (n, m)
    # exact Galerkin projections for the resolvent start and the final
    # band corrections
    Kp64 = Zw64.T @ KZw64
    Mp64 = Zw64.T @ MZ64
    Kp64 = 0.5 * (Kp64 + Kp64.T)
    Mp64 = 0.5 * (Mp64 + Mp64.T)
    if not ki_proportional:
        KiZw64 = panels[2].T                           # (n, m) = K_im Zw
        Kip64 = Zw64.T @ KiZw64
        Kip64 = 0.5 * (Kip64 + Kip64.T)

    # ---- FGMRES shape knobs ---------------------------------------------
    # n_refine is the total budget spent as restarted cycles of k_cycle
    # iterations
    # final true-residual band corrections: each contracts the Ritz-pair
    # defect ~100x, which the two-grid tier's 21k+ DOF need twice
    band_correct_n = 2 if mg is not None else 1
    if k_cycle is None:
        k_cycle = 8
    k_cycle = max(1, min(int(k_cycle), int(n_refine)))
    n_cycles = -(-int(n_refine) // k_cycle)
    if basis_f32:
        n_cycles = max(n_cycles, 2)

    # ---- complement preconditioner: pc(x) in x's dtype ------------------
    if mg is not None:
        if "tg_pack" in mg:
            # band tier: the two-grid cycle, its fine products on K1
            def cycle(x32):
                return twogrid_apply(mg["tg_pack"], mg["dinv"], mg["lmax"],
                                     mg["Pt"], mg["Kc_inv"], x32,
                                     mg["layout"], mg["rl"], mg["slots"])

            def Kref32_mv(y32):
                return band_mv_f32(mg["tg_pack"], y32, mg["layout"])
        else:
            # flat layout: the multilevel cycle, every product on K3
            K032 = mg["Kref32"].reshape(1, -1)

            def cycle(x32):
                return multilevel_apply(mg["multilevel"], K032, csr, x32)

            def Kref32_mv(y32):
                return csr_mv(K032, y32, csr)[0]

        def pc(x):
            # the f32 cycle with f32 refinement rounds around it
            x32 = x.to(f32)
            y32 = cycle(x32)
            for _ in range(_MG_REFINE):
                r32 = x32 - Kref32_mv(y32)
                y32 = y32 + cycle(r32)
            return y32.to(x.dtype)
    else:
        def pc(x):
            # refinement rounds (the JAX package's f32 inverse only): each
            # squares its eps32 * kappa error for one GEMM + one f32 SpMV
            xd = x.to(invK.dtype)
            y = _dense_apply(invK, xd)
            if K_ref32 is not None:
                for _ in range(_PRECOND_REFINE):
                    r = xd - csr_mv(K_ref32[None], y, csr)[0]
                    y = y + _dense_apply(invK, r)
            return y.to(x.dtype)

    if basis_f32:
        Zw32 = Zw64.to(f32)
        MZ32 = MZ64.to(f32)

    def solve_chunk(om, sign: float):
        """Band-resolvent start + FGMRES + final band corrections for the
        frequency lanes ``om`` (L,); right-hand sides (L, 2, n).  ``sign``
        = +1 solves A, -1 conj(A)."""
        om2 = om * om                                   # (L,)
        sb = sign * beta

        def combine(Ku, Mu, Kiu, o2):
            """(re, im) of A u = (K_re + i sign K_im - om^2 M) u from the
            matvecs of the (re, im) pair u (each a pair): K_im u = beta K_re
            u for the scalar-loss families (``Kiu`` None)."""
            if Kiu is None:
                return (Ku[0] - sb * Ku[1] - o2 * Mu[0],
                        Ku[1] + sb * Ku[0] - o2 * Mu[1])
            return (Ku[0] - sign * Kiu[1] - o2 * Mu[0],
                    Ku[1] + sign * Kiu[0] - o2 * Mu[1])
        dre = lam_w[None, :] - om2[:, None]             # (L, m)
        dim = sb * lam_w                                # (m,)
        den_d = dre * dre + dim * dim

        def rsolve_diag(q_re, q_im, li):
            """Diagonal-resolvent model of the projected pencil."""
            d_re, d_den = dre[li], den_d[li]
            return ((q_re * d_re + q_im * dim) / d_den,
                    (q_im * d_re - q_re * dim) / d_den)

        def proj_apply(y_re, y_im, li):
            """Exact projected operator Z^T A Z on (L', m) coefficients."""
            o2 = om2[li][:, None]
            Kiy = (None if ki_proportional
                   else (y_re @ Kip64.T, y_im @ Kip64.T))
            return combine((y_re @ Kp64.T, y_im @ Kp64.T),
                           (y_re @ Mp64.T, y_im @ Mp64.T), Kiy, o2)

        def band_coeffs(q_re, q_im, li):
            """Galerkin solve of the projected system Z^T A Z y = q:
            diagonal resolvent start + 2 refinement passes against the
            exact m x m pencil."""
            y_re, y_im = rsolve_diag(q_re, q_im, li)
            for _ in range(2):
                Ay_re, Ay_im = proj_apply(y_re, y_im, li)
                d_re, d_im = rsolve_diag(q_re - Ay_re, q_im - Ay_im, li)
                y_re = y_re + d_re
                y_im = y_im + d_im
            return y_re, y_im

        def band_stack(rr, li):
            y_re, y_im = band_coeffs(rr[:, 0] @ Zw64, rr[:, 1] @ Zw64, li)
            return torch.stack([y_re @ Zw64.T, y_im @ Zw64.T], dim=1)

        def proj_AZ(x_re, x_im, li):
            """Z^T A x = (A Z)^T x (A complex symmetric) from the panels,
            for (L', n) iterates."""
            Kix = (None if ki_proportional
                   else (x_re @ KiZw64, x_im @ KiZw64))
            return combine((x_re @ KZw64, x_im @ KZw64),
                           (x_re @ MZ64, x_im @ MZ64), Kix, om2[li][:, None])

        def A_apply(uu, li):
            """Exact f64 operator on (L', 2, n): two (three) band DGEMMs
            or one K3 pass over the flat pattern."""
            Ku, Mu, Kiu = KMI_mv(uu)
            return torch.stack(combine(
                Ku.unbind(1), Mu.unbind(1),
                None if Kiu is None else Kiu.unbind(1),
                om2[li][:, None]), dim=1)

        def P_common(rr, band_part, Zm, Pm, pc, li):
            """Band resolvent + the M-deflated complement preconditioner:
            band directions are left to the exact resolvent alone."""
            db = band_part(rr, li)
            rc = rr - (rr @ Zm) @ Pm.T
            dc = pc(rc)
            dc = dc - (dc @ Pm) @ Zm.T
            return db + dc

        if basis_f32:
            # the whole preconditioner in f32 (it only steers the Krylov
            # subspace); the resolvent denominators are computed in f64
            # first (cancellation near lam ~ om^2), then cast
            dre32 = dre.to(f32)
            dim32 = dim.to(f32)
            den32 = dre32 * dre32 + dim32 * dim32

            def band_stack32(rr, li):
                q = rr @ Zw32                           # (L', 2, m)
                d_re, d_den = dre32[li], den32[li]
                y_re = (q[:, 0] * d_re + q[:, 1] * dim32) / d_den
                y_im = (q[:, 1] * d_re - q[:, 0] * dim32) / d_den
                return torch.stack([y_re @ Zw32.T, y_im @ Zw32.T], dim=1)

            def P_apply(rr, li):
                return P_common(rr, band_stack32, Zw32, MZ32, pc, li)
        else:
            def P_apply(rr, li):
                return P_common(rr, band_stack, Zw64, MZ64, pc, li)

        # amplification-aware residual target (forward error ~ kappa(A) x
        # relative residual, kappa ~ 1/beta near a resonance)
        amp = torch.clamp((lam_w[None, :] / torch.sqrt(den_d)).max(1).values,
                          min=1.0)
        tol_eff = torch.clamp(refine_tol / amp, min=3e-12)

        def solve(bbs):
            lanes = torch.arange(bbs.shape[0], device=dev)
            Zb = bbs @ Zw64                             # (L, 2, m) = Z^T b
            y_re, y_im = band_coeffs(Zb[:, 0], Zb[:, 1], lanes)
            x0 = torch.stack([y_re @ Zw64.T, y_im @ Zw64.T], dim=1)
            KiZy = (None if ki_proportional
                    else (y_re @ KiZw64.T, y_im @ KiZw64.T))
            Ax0 = torch.stack(combine(
                (y_re @ KZw64.T, y_im @ KZw64.T),
                (y_re @ MZ64.T, y_im @ MZ64.T), KiZy, om2[:, None]), dim=1)

            def band_correct(x, li):
                """x + Z y with Z^T A Z y = Z^T (b - A x): one final band
                correction on the projected true residual."""
                AZx_re, AZx_im = proj_AZ(x[:, 0], x[:, 1], li)
                y_re, y_im = band_coeffs(Zb[li, 0] - AZx_re,
                                         Zb[li, 1] - AZx_im, li)
                return x + torch.stack([y_re @ Zw64.T, y_im @ Zw64.T], dim=1)

            return _pgmres(A_apply, P_apply, bbs, x0, tol_eff, k_cycle,
                           n_cycles, bbs - Ax0, band_correct, band_correct_n,
                           basis_f32, diagnostics, n_rescue=n_cycles)

        return solve

    om64 = omegas.to(f64)
    F = om64.shape[0]
    bb = torch.stack([B_re.to(f64), B_im.to(f64)], dim=1)        # (F, 2, n)
    # every lane is solved for its right-hand side scaled to max |b| = 1
    # and scaled back: the iteration does not depend on the scale of b (an
    # adjoint right-hand side dr_i/dU_i can be tiny without its squared
    # norms underflowing), and lanes that differ only in scale get the
    # same solve; an all-zero lane stays zero
    scale = bb.abs().amax((1, 2))
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    bb = bb / scale[:, None, None]
    chunk = F if freq_chunk is None else max(1, min(int(freq_chunk), F))
    # difficulty sort: every lane of a chunk pays the chunk's worst
    # iteration count, so group frequencies by resonance amplification
    den_f = torch.sqrt((lam_w[None, :] - (om64 ** 2)[:, None]) ** 2
                       + (beta * lam_w[None, :]) ** 2)
    amp_f = (lam_w[None, :] / den_f).max(1).values
    order = torch.argsort(amp_f, stable=True)
    U = torch.empty_like(bb)
    info = torch.empty(4, F, dtype=f64, device=dev)     # rn, rn_fin, rn0, tol
    for lo in range(0, F, chunk):
        sel = order[lo:lo + chunk]
        out = solve_chunk(om64[sel], -1.0 if adjoint else 1.0)(bb[sel])
        if diagnostics:
            out, *norms = out
            info[:, sel] = torch.stack(norms)
        U[sel] = out
    U = U * scale[:, None, None]
    if diagnostics:
        rn, rn_fin, rn0, tol = info * scale
        return U[:, 0], U[:, 1], rn, rn_fin, rn0, tol
    return U[:, 0], U[:, 1]
