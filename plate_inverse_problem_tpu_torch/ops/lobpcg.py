"""LOBPCG band basis — the factorization-free band basis (port of the JAX
package's ``ops/lobpcg.py``).

Why: the mixed engine's band basis (``ops.mixed.band_basis_host``) is the
last f64 factorization of construction — ARPACK shift-invert needs a host
``splu`` of the equilibrated reference stiffness, serial host time that
grows superlinearly with n.  Everything LOBPCG needs instead is already on
the Problem's device:

* the exact f64 K/M applications: on the flat tier one launch of the CSR
  kernel (K3, ops/csr_kernel.py) over the (K, M) stack, on the band tier
  the RCM block-tridiagonal f64 product (ops/band.py ``band_mv``), and
* the mixed engine's own complement preconditioner as T ~= K^-1: the
  port's dense f64 inverse below 12288 DOF (one GEMM,
  ``dense.dense_apply``), the band two-grid cycle above (its band matvec
  the band kernel, K1) — the same object that preconditions the sweep.

With T ~= K^-1 the preconditioned pencil has O(1) effective condition
number, so the 1e8 raw spectral spread of the biharmonic operator never
enters the iteration count.

Structure: a host loop, init-time prep like the ARPACK path it replaces,
with every panel operation on the device: operator applications,
preconditioner cycles, Gram matrices, panel recombinations, and the small
(3b, 3b) reduced Rayleigh-Ritz in f64 (``torch.linalg.eigh``; the JAX
package takes that one to the host only because the TPU has no f64
eigh).  Each iteration reads one boolean back, the convergence test.

Algorithm: Knyazev's LOBPCG on the generalized pencil (K, M), soft
locking, with basis conditioning done through the eigendecomposition of
the M-Gram (an SVQB-style whitening: near-dependent directions in
[X W P] are dropped by a relative eigenvalue threshold instead of
crashing a Cholesky).  The start block is seeded numpy normals, the
numbers the JAX package draws, so one pencil gives one basis.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


# ---------------------------------------------------------------------------
# reduced Rayleigh-Ritz with SVQB-style whitening
# ---------------------------------------------------------------------------

def _reduced_rr(A, B, nx: int, drop_tol: float = 1e-12):
    """Rayleigh-Ritz for the reduced pencil (A, B), B ~ Gram (SPSD), f64
    tensors on any device (the computation runs where they lie).

    Whitens B by its eigendecomposition, dropping directions whose B-mass
    is below ``drop_tol`` relative to the largest (near-dependent W/P
    columns — expected as modes converge, not an error), then solves the
    whitened standard problem.  Returns (theta (nx,), C (s, nx)) with C
    B-orthonormal: C^T B C = I.
    """
    A = 0.5 * (A + A.T)
    B = 0.5 * (B + B.T)
    d, V = torch.linalg.eigh(B)
    keep = d > drop_tol * max(float(d[-1]), np.finfo(np.float64).tiny)
    # never drop below the block size we must return
    if int(keep.sum()) < nx:
        keep = torch.zeros_like(keep)
        keep[-nx:] = True
    Y = V[:, keep] / torch.sqrt(d[keep])
    Ar = Y.T @ A @ Y
    lam, Q = torch.linalg.eigh(0.5 * (Ar + Ar.T))
    C = Y @ Q[:, :nx]
    return lam[:nx], C


# ---------------------------------------------------------------------------
# panel steps
# ---------------------------------------------------------------------------

def _expand_body(apply_KM, apply_T, X, P, KX, MX, KP, MP, theta,
                 use_p: bool):
    """Residual -> preconditioned direction -> subspace Grams.

    All panels are (b, n) f64.  Returns the new W panel with its K/M
    images plus the reduced Gram matrices and squared residual norms."""
    R = KX - theta[:, None] * MX
    W = apply_T(R)
    # Convergence measure: ||T r|| / ||x||.  The RAW residual of a low mode
    # is dominated by its high-mode error components AMPLIFIED by lam_max
    # (1e8 spectral spread), so ||r||/theta only fires at eps64 — useless.
    # T ~= K^-1 undoes exactly that amplification: e = K^-1 r is the
    # eigenvector error itself (to first order), so ||T r||/||x|| tracks
    # the subspace angle the band basis actually needs.
    rn2 = (W * W).sum(1) / (X * X).sum(1)
    KW, MW = apply_KM(W)
    # Normalize W in the M-NORM, like X (||x||_M = 1 by construction).
    # The mass matrix of the equilibrated pencil has O(1e-11) entries, so
    # a 2-normalized W row has M-norm ~3e5 smaller than an X row: the
    # combined Gram B would span ~11 decades and the f64 whitening would
    # lose the W directions to roundoff (the JAX package measured
    # stagnation at relres ~4 with a spectrally-excellent T).
    nw = torch.sqrt(torch.abs((W * MW).sum(1)))
    nw = torch.where(nw > 0, nw, torch.ones_like(nw))[:, None]
    W, KW, MW = W / nw, KW / nw, MW / nw
    parts = (X, W, P) if use_p else (X, W)
    S = torch.cat(parts)
    KS = torch.cat((KX, KW, KP) if use_p else (KX, KW))
    MS = torch.cat((MX, MW, MP) if use_p else (MX, MW))
    return W, KW, MW, S @ KS.T, S @ MS.T, rn2


def _combine_body(X, W, P, KX, MX, KW, MW, KP, MP, C, Cp, use_p: bool):
    """New (X, P) blocks and their K/M images as reduced combinations —
    panel matmuls, no operator application."""
    S = torch.cat((X, W, P) if use_p else (X, W))
    KS = torch.cat((KX, KW, KP) if use_p else (KX, KW))
    MS = torch.cat((MX, MW, MP) if use_p else (MX, MW))
    Xn, KXn, MXn = C.T @ S, C.T @ KS, C.T @ MS
    Pn, KPn, MPn = Cp.T @ S, Cp.T @ KS, Cp.T @ MS
    # M-renormalize P: its rows shrink as modes converge (P -> 0), which
    # would starve the next Gram of its directions' scale
    npn = torch.sqrt(torch.abs((Pn * MPn).sum(1)))
    npn = torch.where(npn > 1e-150, npn, torch.ones_like(npn))[:, None]
    return Xn, Pn / npn, KXn, MXn, KPn / npn, MPn / npn


# ---------------------------------------------------------------------------
# the iteration
# ---------------------------------------------------------------------------

def lobpcg_pencil(apply_KM, apply_T, X0, *, n_wanted: int,
                  tol: float = 1e-4, maxiter: int = 200):
    """Lowest ``n_wanted`` eigenpairs of the SPD pencil (K, M).

    ``apply_KM(U) -> (KU, MU)`` and ``apply_T(R) -> W`` are panel functions
    over (b, n) f64 tensors (the JAX package's also take the operator
    pytree, its jit arguments; here the closures hold it).  ``X0`` (b, n)
    f64 on the device is the start block, b >= n_wanted (extra rows act
    as a guard block that accelerates the wanted modes).

    Differs from the JAX ``lobpcg_pencil``: no ``opd`` argument.

    Returns (lam (b,), X (b, n) M-orthonormal, relres (b,), n_iter), the
    first three f64 tensors on X0's device; convergence is judged on the
    first ``n_wanted`` modes.
    """
    b, n = X0.shape
    if not (0 < n_wanted <= b):
        raise ValueError(f"n_wanted={n_wanted} outside block size {b}")

    # ---- M-orthonormalize the start block (eigh of the M-Gram) ----------
    X = X0.to(F64)
    KX, MX = apply_KM(X)
    G = X @ MX.T
    d, V = torch.linalg.eigh(0.5 * (G + G.T))
    keep = d > 1e-12 * d[-1]
    if int(keep.sum()) < b:
        raise ValueError("start block is M-rank-deficient; use a random X0")
    C0 = V[:, keep] / torch.sqrt(d[keep])
    X, KX, MX = C0.T @ X, C0.T @ KX, C0.T @ MX
    theta = (X * KX).sum(1)

    P = torch.zeros_like(X)
    KP = torch.zeros_like(X)
    MP = torch.zeros_like(X)

    relres = torch.full((b,), float("inf"), dtype=F64, device=X.device)
    it = 0
    converged = False
    for it in range(1, maxiter + 1):
        use_p = it > 1
        W, KW, MW, A, B, rn2 = _expand_body(apply_KM, apply_T, X, P, KX, MX,
                                            KP, MP, theta, use_p)
        relres = torch.sqrt(torch.clamp(rn2, min=0.0))
        if bool((relres[:n_wanted] < tol).all()):
            converged = True
            break

        lam, C = _reduced_rr(A, B, b)
        Cp = C.clone()
        Cp[:b, :] = 0.0  # P = the W/P-component of the update (Knyazev)
        X, P, KX, MX, KP, MP = _combine_body(X, W, P, KX, MX, KW, MW, KP, MP,
                                             C, Cp, use_p)
        theta = lam

    if not converged:
        # maxiter exit: the last combine replaced X/theta AFTER relres was
        # measured — recompute so the returned residuals describe the
        # returned block (one extra panel apply, failure path only)
        *_, rn2 = _expand_body(apply_KM, apply_T, X, P, KX, MX, KP, MP,
                               theta, True)
        relres = torch.sqrt(torch.clamp(rn2, min=0.0))

    # ---- exact M-orthonormalization of the result (Cholesky) ------------
    order = torch.argsort(theta)
    X, MX, lam = X[order], MX[order], theta[order]
    G = X @ MX.T
    L = torch.linalg.cholesky(0.5 * (G + G.T))
    X = torch.linalg.solve_triangular(L, X, upper=False)
    return lam, X, relres[order], it


# ---------------------------------------------------------------------------
# the band-basis entry point (drop-in alternative to band_basis_host)
# ---------------------------------------------------------------------------

def _make_applies(n: int, K64, M64, csr=None, band=None, precond=None):
    """(apply_KM, apply_T) from the mixed engine's operator and
    preconditioner data on one device.

    ``K64``/``M64`` (nnz,) f64: the flat operator data, on ``csr`` (the
    pattern's CSR plan, ops/csr_kernel.build_csr) — one K3 launch over the
    (K, M) stack applies both; or with ``band`` {"layout": BandLayout,
    "lin": (nnz,) int64} the exact f64 block-tridiagonal product of each.
    ``precond``: {"kind": "dense", "invK" (n, n), "refine"} (the dense
    inverse, applied in its own dtype: f64, the port's) or {"kind":
    "twogrid", "pack", "dinv", "Pt", "Kc_inv", "slots", "lmax", "layout",
    "rl", "refine"} (the band two-grid cycle in f32, K1) — the same cycle
    objects as ops/mixed.py's preconditioner; ``refine`` here is the DEPTH
    of the inner flexible GCR wrapped around the cycle (``gcr_T``).
    """
    from .csr_kernel import csr_mv
    from .dense import dense_apply
    from .mg import twogrid_apply

    if band is not None:
        from .band import band_mv, flat_to_band

        layout = band["layout"]
        Kband = flat_to_band(K64, layout, band["lin"])
        Mband = flat_to_band(M64, layout, band["lin"])

        def apply_KM(U):
            return band_mv(Kband, U, layout), band_mv(Mband, U, layout)

        def apply_K(U):
            return band_mv(Kband, U, layout)
    else:
        KM = torch.stack([K64, M64])

        def apply_KM(U):
            out = csr_mv(KM, U, csr)
            return out[0], out[1]

        def apply_K(U):
            return csr_mv(KM[:1], U, csr)[0]

    kind = precond["kind"]
    if kind == "dense":
        invK = precond["invK"]

        def cycle(x):
            return dense_apply(invK, x).to(F64)
    elif kind == "twogrid":
        pc = precond

        def cycle(x):
            return twogrid_apply(pc["pack"], pc["dinv"], pc["lmax"], pc["Pt"],
                                 pc["Kc_inv"], x.to(torch.float32),
                                 pc["layout"], pc["rl"],
                                 pc["slots"]).to(F64)
    else:
        raise ValueError(f"Unknown preconditioner kind {kind!r}")
    return apply_KM, gcr_T(apply_K, cycle, int(precond.get("refine", 8)))


def gcr_T(apply_K, cycle, refine: int = 8):
    """T ~= K_ref^-1 as a FIXED-depth flexible GCR solve — f64
    iterates/residuals/matvecs (``apply_K``) around the preconditioner
    ``cycle`` ((b, n) f64 -> f64, computing in its own precision).

    A single f32 preconditioner application is NOT usable as a LOBPCG
    preconditioner: the f32 inverse / two-grid cycle carries
    eps32*kappa-level error that is O(1)-or-worse in the stiffest
    directions (the JAX package measured ~1e2-1e3 on the equilibrated
    plate operator), i.e. it is not spectrally equivalent to K^-1 and not
    SPD — LOBPCG stagnates (the sweep's FGMRES tolerates the same object
    only because it is residual-minimizing, flexible AND keeps f64
    iterates).  An all-f32 inner solve does not fix it either: the f32
    arithmetic floors the inner residual at eps32*kappa ~ O(1).  The
    working recipe is the mixed engine's own precision placement — EXACT
    f64 operator applications and f64 GCR iterates, only the cycle in f32
    — which contracts the residual ~1.5 digits per iteration in every
    direction; depth 4-8 then hands LOBPCG a spectrally-excellent T.
    (With the port's f64 dense inverse the first step is already exact to
    its rounding; the depth stays the JAX package's.)
    """
    def apply_T(R):
        x = torch.zeros_like(R)
        r = R
        qs = []
        zs = []
        for _ in range(refine):
            z = cycle(r)
            q = apply_K(z)
            for qi, zi in zip(qs, zs):
                a = (q * qi).sum(1)[:, None]
                q = q - a * qi
                z = z - a * zi
            nq = torch.linalg.vector_norm(q, dim=1, keepdim=True)
            nq = torch.where(nq > 0, nq, torch.ones_like(nq))
            q = q / nq
            z = z / nq
            qs.append(q)
            zs.append(z)
            g = (r * q).sum(1)[:, None]
            x = x + g * z
            r = r - g * q
        return x

    return apply_T


def band_basis_lobpcg(K_flat_ref, M_flat, rows, cols, n: int,
                      omega_max: float, *, precond: dict, csr=None,
                      band_layout=None, band_lin=None,
                      margin: float = 2.5, m_min: int = 16, m_max: int = 256,
                      tol: float = 2e-4, maxiter: int = 250,
                      guard: int | None = None, seed: int = 0):
    """Factorization-free counterpart of ``ops.mixed.band_basis_host``.
    Differs from the JAX ``band_basis_lobpcg``: it returns tensors, and
    takes the pattern's K3 plan (``csr``) and a ``seed``.

    Same contract: returns (W (n, m) f64 M-orthonormal, lam (m,)), here
    tensors on the operator data's device, covering the sweep band [0,
    (margin * omega_max)^2], growing m adaptively from ``m_min`` until the
    band edge is covered (or ``m_max``), with a guard block of min(max(4,
    m / 8), 32) extra rows (``guard``).  The tolerance is deliberately
    modest: the basis only needs to SPAN the low band — the mixed engine
    re-Rayleigh-Ritzes it per theta in f64 and the FGMRES complement
    iteration absorbs residual subspace angle (ops/mixed.py docstring).

    ``K_flat_ref``/``M_flat`` (nnz,) f64 tensors on the device (numpy is
    moved to the device of the preconditioner's data) on the pattern
    (``rows``, ``cols``), with its CSR plan ``csr`` (built here when
    None); ``band_basis_lobpcg.rounds`` records the call's rounds of m
    (m, block rows, iterations); ``band_layout`` + ``band_lin``: the band
    tier's layout and its device scatter targets (the flat data then apply as f64 band
    products); ``precond``: see ``_make_applies``.
    """
    from .csr_kernel import build_csr

    if precond["kind"] == "dense":
        dev = precond["invK"].device
    else:
        dev = precond["pack"].vals.device
    K64 = torch.as_tensor(K_flat_ref, dtype=F64, device=dev)
    M64 = torch.as_tensor(M_flat, dtype=F64, device=dev)
    band = None
    if band_layout is not None:
        lin = band_layout.lin if band_lin is None else band_lin
        band = {"layout": band_layout,
                "lin": torch.as_tensor(lin, dtype=torch.int64, device=dev)}
    elif csr is None:
        csr = build_csr(torch.as_tensor(rows, device=dev),
                        torch.as_tensor(cols, device=dev), n)
    apply_KM, apply_T = _make_applies(n, K64, M64, csr=csr, band=band,
                                      precond=precond)

    target = (margin * omega_max) ** 2
    rng = np.random.default_rng(seed)
    m = int(min(max(m_min, 8), n - 2))
    X_seed = None
    rounds = band_basis_lobpcg.rounds = []
    while True:
        g = min(max(4, m // 8), 32) if guard is None else guard
        bsz = min(m + g, n - 1)
        X0 = torch.as_tensor(rng.standard_normal((bsz, n)), dtype=F64,
                             device=dev)
        if X_seed is not None:
            # T-filter only the NEW random rows (converged rows stay)
            X0 = torch.cat([X_seed, apply_T(X0[X_seed.shape[0]:])])
        else:
            # one preconditioner pass enriches the low band in the start
            X0 = apply_T(X0)
        lam, X, relres, it = lobpcg_pencil(
            apply_KM, apply_T, X0, n_wanted=m, tol=tol, maxiter=maxiter)
        rounds.append((m, bsz, it))
        if float(lam[m - 1]) >= target or m >= min(m_max, n - 2):
            break
        X_seed = X
        m = int(min(m * 2, m_max, n - 2))

    keep = max(int((lam[:m] < target).sum()) + 1, m_min)
    keep = min(keep, m)
    return X[:keep].T.contiguous(), lam[:keep]


# (m, block rows, iterations) of each round of the last call
band_basis_lobpcg.rounds = []
