"""The modal and direct sweep engines (port of the JAX package's
``ops/sweep.py``) in the split (re, im) f64 form of the port's hooks.

Each solves A(omega_i) u_i = b_i for a batch of lanes, A(omega) = K -
omega^2 M over the static flat pattern (K = K_re + i K_im), or the adjoint
system conj(A) y = g (``adjoint``: the transpose of the real split-complex
operator of the complex symmetric A).  Right-hand sides and solutions are
(L, n) f64 pairs, lane i at ``omegas[i]``.  No solve is differentiated:
the Problem's implicit rules (``_ImplicitSweep``) carry the derivatives
through the residual map.

* **modal** — one generalized eigh of (Re K, M) per parameter set
  (``ops/spectral.py``), its Rayleigh-quotient polish against the flat
  operators (K3), then per lane the resolvent Z diag(1/d) Z^T with
  d = (1 + i beta) lam - omega^2 and ``refine_steps`` rounds of
  u += R(b - A u) against the true complex A (K3).  Exact for the scalar
  loss-factor families; beta, the least-squares projection of K_im on
  K_re, is only the resolvent's model of a per-modulus material, which
  the refinement then corrects only in part (as in the JAX package).
* **direct** — dense A(omega) per chunk of distinct frequencies, built
  from the flat pattern by index assignment, and one complex128 LU each,
  a matrix at a time (``torch.linalg.lu_factor`` / ``lu_solve``); every
  lane at a frequency is solved from its one factorisation.  Exact for
  any complex stiffness, frequency-dependent materials included (K (L,
  nnz), a row per lane).
"""
from __future__ import annotations

import torch

from . import mixed
from .csr_kernel import csr_apply, csr_mv
from .mixed import mixed_apply
from .scatter import to_dense
from .spectral import modal_basis_from_flat

C128 = torch.complex128


def _loss_factor(K_re, K_im):
    """beta of K = (1 + i beta) K_re by least-squares projection of the
    flat K_im data on the flat K_re data."""
    return torch.dot(K_re, K_im) / torch.dot(K_re, K_re)


# ---------------------------------------------------------------------------
# modal engine
# ---------------------------------------------------------------------------

def modal_basis(K_re, M_flat, rows, cols, n: int, n_modes: int | None,
                csr):
    """(lam (m,), Z (n, m)): the eigenbasis of (Re K, M), polished with
    Rayleigh quotients against the flat operators — lam_i = z_i^T K z_i /
    z_i^T M z_i and Z rescaled to unit M-norm, the two products one K3
    launch (``csr``, the pattern's CSR copy) over the n basis vectors as
    lanes — then truncated to the lowest ``n_modes`` (None: all n).
    Outside autograd."""
    with torch.no_grad():
        Kr = K_re.detach().to(torch.float64)
        Ms = M_flat.detach().to(torch.float64)
        lam, Z = modal_basis_from_flat(Kr, Ms, rows, cols, n)
        Zt = Z.T.contiguous()
        # rows K z_i, M z_i (the plain version on the CPU walks nnz in
        # segments that bound its (2, n, seg) contribution tensor)
        seg = max(1024, int(mixed._APPLY_BUDGET // (16 * n)))
        KZ, MZ = csr_mv(torch.stack([Kr, Ms]), Zt, csr, seg)
        zKz = (Zt * KZ).sum(1)
        zMz = (Zt * MZ).sum(1)
        lam = zKz / zMz
        Z = Z / torch.sqrt(zMz)[None, :]
        if n_modes is not None:
            lam, Z = lam[:n_modes], Z[:, :n_modes]
        return lam, Z.contiguous()


def _modal_solve(K_re, K_im, M_flat, B_re, B_im, Z, lam, omegas, rows, cols,
                 n: int, refine_steps: int = 2, adjoint: bool = False,
                 csr=None, ki_proportional: bool = True):
    """The modal resolvent R = Z diag(1/d) Z^T (adjoint: 1/conj(d)) and
    ``refine_steps`` rounds of u += R(b - A u) with the exact split-complex
    A (conj(A) for the adjoint) through K3 (``mixed_apply``).  Each R is
    two f64 GEMMs over the (re, im) lanes stacked."""
    beta = _loss_factor(K_re, K_im)
    om2 = omegas.to(torch.float64) ** 2
    d = (1.0 + 1j * beta) * lam.to(C128)[None, :] - om2.to(C128)[:, None]
    if adjoint:
        d = d.conj()
    L = B_re.shape[0]

    def resolvent(r_re, r_im):
        t = torch.cat([r_re, r_im]) @ Z                  # (2L, m)
        q = torch.complex(t[:L], t[L:]) / d
        u = torch.cat([q.real, q.imag]) @ Z.T            # (2L, n)
        return u[:L], u[L:]

    k_im = -K_im if adjoint else K_im
    u_re, u_im = resolvent(B_re, B_im)
    for _ in range(refine_steps):
        Au_re, Au_im = mixed_apply(K_re, k_im, M_flat, omegas, u_re, u_im,
                                   rows, cols, n,
                                   ki_proportional=ki_proportional, csr=csr)
        c_re, c_im = resolvent(B_re - Au_re, B_im - Au_im)
        u_re, u_im = u_re + c_re, u_im + c_im
    return u_re, u_im


def modal_sweep(K_re, K_im, M_flat, B_re, B_im, omegas, rows, cols, n: int,
                basis, csr, refine_steps: int = 2, *, adjoint: bool = False,
                ki_proportional: bool = True):
    """Modal-resolvent sweep: (U_re, U_im), each (L, n) f64.  ``basis``:
    (lam, Z) of ``modal_basis`` for this K_re, which the Problem computes
    once per parameter set (truncated to ``n_modes`` there: a Rayleigh-Ritz
    approximation that the refinement rounds correct only in part)."""
    with torch.no_grad():
        lam, Z = basis
        return _modal_solve(K_re.detach(), K_im.detach(), M_flat, B_re,
                            B_im, Z, lam, omegas, rows, cols, n,
                            refine_steps=refine_steps, adjoint=adjoint,
                            csr=csr, ki_proportional=ki_proportional)


def lane_apply(C_re, C_im, stack, M_flat, omegas, U_re, U_im, csr,
               adjoint: bool = False):
    """A_i U_i (``adjoint``: conj(A_i) U_i) for lanes with operators of
    their own, K_i = sum_k C_ik S_k over the basis stack S (S, nnz) (a
    frequency-dependent material's per-lane coefficients C_re / C_im
    (L, S)): one K3 pass of [S; M] over the lanes (in chunks that keep the
    (S + 1, 2, lanes, nnz) reverse-mode gathers under the mixed engine's
    ``_APPLY_BUDGET``), then each lane's contraction with its own
    coefficients.  Differentiable in the coefficients, forward and reverse
    mode, at fixed U.  Returns (AU_re, AU_im), each (L, n) f64."""
    f64 = torch.float64
    S = stack.shape[0]
    data = torch.cat([stack.to(f64), M_flat.to(f64)[None]])
    uu = torch.stack([U_re.to(f64), U_im.to(f64)])
    seg = min(int(stack.shape[1]), mixed._RES_SEG)
    chunk = mixed._apply_chunk(S + 1, seg)
    out = torch.cat([csr_apply(data, uu[:, lo:lo + chunk], csr, seg)
                     for lo in range(0, uu.shape[1], chunk)], dim=2)
    KU_re = torch.einsum("lk,kcln->cln", C_re, out[:S])
    KU_im = torch.einsum("lk,kcln->cln", C_im, out[:S])
    if adjoint:
        KU_im = -KU_im
    om2 = (omegas.to(f64) ** 2)[:, None]
    MU = out[S]
    return (KU_re[0] - KU_im[1] - om2 * MU[0],
            KU_re[1] + KU_im[0] - om2 * MU[1])


# ---------------------------------------------------------------------------
# direct engine
# ---------------------------------------------------------------------------

def dense_operator(K_re, K_im, M_flat, omegas, rows, cols, n: int):
    """Dense complex128 A(omega_g) = K_g - omega_g^2 M, (G, n, n), from the
    flat data: K (nnz,) shared or (G, nnz), a row per matrix.  Each pattern
    slot is assigned once (``to_dense``: no atomics)."""
    K = torch.complex(K_re, K_im)
    if K.dim() == 1:
        K = K[None, :]
    om2 = (omegas.to(torch.float64) ** 2)[:, None]
    vals = K - (om2 * M_flat.to(torch.float64)[None, :]).to(C128)
    return to_dense(vals, rows, cols, n)


def direct_sweep(K_re, K_im, M_flat, B_re, B_im, omegas, rows, cols, n: int,
                 chunk: int = 16, *, adjoint: bool = False):
    """Chunked dense-LU sweep: (U_re, U_im), each (L, n) f64.

    The lanes are grouped by frequency (a tangent or adjoint batch repeats
    each frequency), the distinct frequencies taken ``chunk`` at a time in
    ascending order: A(omega) of the chunk's frequencies is built at once,
    each factored once (``torch.linalg.lu_factor``, complex128), and every
    lane at a frequency is a column of its one ``lu_solve``.  The adjoint
    lanes solve conj(A) y = g as y = conj(A^-1 conj(g)) from the same
    factors.  K_re / K_im: (nnz,) flat data, or (L, nnz) with a row per
    lane (a frequency-dependent material; the lanes of one frequency share
    their row).

    Each matrix is factored and solved as a batch of one.  On the card
    torch dispatches a batch of matrices to other LU routines than a
    single one, which round otherwise (on an NVIDIA H100, 8e-10 relative
    at the bench plate's 150 Hz point, three frequencies in one batch
    against one alone: ``.probes/direct_lu_witness.py``); one at a time, a
    lane's bits do not depend on which frequencies share its chunk, or on
    ``chunk``.  The price there: 16 bench matrices take 1.5x the time of
    one batched call.

    No refinement: the JAX package refines only its complex64 LU (with
    split-f64 residuals, its ``_residual_general``), 0 rounds in
    complex128; the port's engine is complex128 only."""
    with torch.no_grad():
        omegas = omegas.to(torch.float64)
        uniq, inv = torch.unique(omegas, return_inverse=True)
        order = torch.argsort(inv, stable=True)
        counts = torch.bincount(inv, minlength=uniq.shape[0])
        start = torch.cumsum(counts, 0) - counts
        first = order[start]                 # one lane of each frequency
        starts, sizes = start.tolist(), counts.tolist()
        per_lane = K_re.dim() == 2
        B = torch.complex(B_re.to(torch.float64), B_im.to(torch.float64))
        if adjoint:
            B = B.conj()
        U = torch.empty_like(B)
        for lo in range(0, uniq.shape[0], chunk):
            hi = min(lo + chunk, uniq.shape[0])
            rep = first[lo:hi]
            A = dense_operator(K_re[rep] if per_lane else K_re,
                               K_im[rep] if per_lane else K_im, M_flat,
                               uniq[lo:hi], rows, cols, n)
            for g in range(lo, hi):
                LU, piv = torch.linalg.lu_factor(A[g - lo:g - lo + 1])
                lanes = order[starts[g]:starts[g] + sizes[g]]
                X = torch.linalg.lu_solve(LU, piv, B[lanes].T[None])
                U[lanes] = X[0].T
        if adjoint:
            U = U.conj()
        return U.real.contiguous(), U.imag.contiguous()


def sweep_solve(K_re, K_im, M_flat, B_re, B_im, omegas, rows, cols, n: int,
                engine: str = "modal", chunk: int = 16, *,
                adjoint: bool = False, csr=None, ki_proportional: bool = True,
                basis=None):
    """Engine dispatch (JAX ``sweep_solve``): 'modal' (the resolvent of the
    Problem's per-parameter-set ``basis`` and K3 refinement over ``csr``)
    or 'direct' (chunked dense LU).  The mixed engine has its own entry,
    ``ops/mixed.py``'s ``mixed_sweep``.  Returns (U_re, U_im), each (L, n)
    f64."""
    if engine == "modal":
        return modal_sweep(K_re, K_im, M_flat, B_re, B_im, omegas, rows,
                           cols, n, basis, csr, adjoint=adjoint,
                           ki_proportional=ki_proportional)
    if engine == "direct":
        return direct_sweep(K_re, K_im, M_flat, B_re, B_im, omegas, rows,
                            cols, n, chunk, adjoint=adjoint)
    raise ValueError(
        f"Unknown sweep engine {engine!r}; use 'modal'/'direct'.")
