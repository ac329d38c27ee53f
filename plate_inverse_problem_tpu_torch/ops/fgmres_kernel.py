"""The FGMRES cycle's Givens least squares as hand-written CUDA kernels
(``csrc/fgmres_lsq.cu``): K7a ``givens_step``, one launch an Arnoldi step,
and K7b ``backsub``, one launch a cycle.

Counterpart of the scalar work that XLA fuses into the JAX package's
FGMRES loop body (``ops/mixed.py`` ``_pgmres_cycle_body``): the rotations
of the new Hessenberg column, the new rotation, g, the residual estimate
and the re-anchored target (K7a), and the back-substitution (K7b).  The
reconstruction x + Z y stays a torch einsum in ``ops/mixed.py``, as the
JAX package leaves it to an einsum.  Pieces:

* ``givens_step_reference`` / ``backsub_reference`` — the plain torch
  versions, on (L,) lane vectors; used for CPU tensors and as the kernels'
  reference on the card.  ``.cuda_calls`` counts their calls on CUDA
  tensors (the main path makes none);
* ``givens_step_cuda`` / ``backsub_cuda`` — check their tensors, launch the
  kernel on the current stream and raise if the launch fails;
  ``.launches`` counts their launches.  A cycle's state (``STATE_KEYS``)
  is checked at its first step and kept (``_Cycle``, weakly) with its
  pointers: a later step checks only its own four tensors, and the
  cycle's back-substitution only ``j_fin``;
* ``givens_step`` / ``backsub`` — what ``_pgmres_cycle`` calls: the kernel
  for a CUDA tensor, the plain version for a CPU tensor;
* ``build`` — compiles the source with nvcc for ``sm_90a`` into
  ``build/kernels/`` at first use and loads it with ``ctypes``;
  ``bucket(k)`` is the kernels' compile-time width for k (8, 16, 32 or
  64; 0 past 64, which the wrappers refuse).

The kernels repeat the plain versions operation for operation, in the same
order, each product and sum a rounding intrinsic that is never fused into a
multiply-add, so they give the plain versions' bits.  Nothing here falls back: a CUDA tensor always goes to the kernel,
and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import os
import weakref

import torch

from .band_kernel import BUILD_DIR, _PKG_DIR, compile_source

SOURCE = os.path.join(_PKG_DIR, "csrc", "fgmres_lsq.cu")
_LIB_PATH = os.path.join(BUILD_DIR, "libfgmres_lsq.so")
_TINY = 1e-300

_lib = None
# the most Krylov steps a cycle the kernels take, as the library reports it
_kmax = None


class _State(ctypes.Structure):
    """``fgmres_state`` of ``csrc/fgmres_lsq.cu``: a cycle's state
    pointers (``STATE_KEYS``' order), L and k."""
    _fields_ = [(key, ctypes.c_void_p) for key in (
        "cs", "sn", "R", "g", "rn2", "tol2", "beta0", "tol_rel")] + [
        ("L", ctypes.c_int), ("k", ctypes.c_int)]


def build() -> str:
    """Compile ``csrc/fgmres_lsq.cu`` (``band_kernel.compile_source``) and
    load it.  Returns the compiler's report of the build."""
    global _lib, _kmax
    report = compile_source(SOURCE, _LIB_PATH)
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.givens_step_launch.argtypes = [ctypes.POINTER(_State)] \
            + [p] * 4 + [i] * 2 + [p]
        lib.givens_step_launch.restype = i
        lib.backsub_launch.argtypes = [p] * 4 + [i] * 2 + [p]
        lib.backsub_launch.restype = i
        lib.fgmres_lsq_kmax.restype = i
        lib.fgmres_lsq_bucket.argtypes = [i]
        lib.fgmres_lsq_bucket.restype = i
        _kmax = lib.fgmres_lsq_kmax()
        _lib = lib
    return report


def bucket(k: int) -> int:
    """The kernels' compile-time width for k steps a cycle: the smallest of
    8, 16, 32, 64 that holds k, as the library picks it; 0 for none."""
    if _lib is None:
        build()
    return _lib.fgmres_lsq_bucket(int(k))


def reset_launches() -> None:
    """Set the launch and plain-call counters to 0."""
    givens_step_cuda.launches = 0
    backsub_cuda.launches = 0
    givens_step_reference.cuda_calls = 0
    backsub_reference.cuda_calls = 0


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _dot_in_order(a, b):
    """sum_p a[:, p] * b[:, p], one addition at a time in column order (the
    kernel's order; a torch reduction's differs from device to device)."""
    acc = a[:, 0] * b[:, 0]
    for p in range(1, a.shape[1]):
        acc = acc + a[:, p] * b[:, p]
    return acc


# ---------------------------------------------------------------------------
# K7a: one Arnoldi step's Givens update
# ---------------------------------------------------------------------------

def givens_step_reference(hre, him, hlast, cs, sn, R, g, rn2, tol2, beta0,
                          tol_rel, active, j: int, anchor: bool) -> None:
    """Step ``j`` of the cycle's Givens least squares, in place on the
    lanes where ``active`` holds.

    ``hre``/``him`` (L, k+1): the new column's CGS2 coefficients, ``hlast``
    (L,) the norm of the new basis vector (slot j+1).  State: ``cs`` (L,
    k), ``sn`` (L, k, 2), ``R`` (L, k, k, 2), ``g`` (L, k+1, 2), the
    residual estimate ``rn2`` and the target ``tol2`` (L,).  ``anchor``: the
    first step of an anchored cycle, which sets tol2 = (tol_rel max(|g[j+1]|,
    1e-13 beta0))^2.  All f64."""
    if hre.is_cuda:
        givens_step_reference.cuda_calls += 1
    L, k = cs.shape
    f64 = hre.dtype
    tiny = _TINY
    zero = torch.zeros(L, 1, dtype=f64, device=hre.device)
    hre = torch.cat([hre, zero], dim=1)
    him = torch.cat([him, zero], dim=1)
    hre[:, j + 1] = hlast
    # apply the accumulated rotations to the new column (rotations beyond
    # the current step are the identity)
    for i in range(k):
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

    # new rotation [[c, s], [-conj(s), c]] (c real) annihilating slot j+1;
    # degenerate a -> c = 0, s = phase of conj(b); both zero -> identity
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
    sn[:, j] = torch.where(active[:, None], torch.stack([s[0], s[1]], dim=1),
                           sn[:, j])

    top = _cmul((c, 0.0 * c), a)
    top = (top[0] + s[0] * b[0] - s[1] * b[1],
           top[1] + s[0] * b[1] + s[1] * b[0])
    hre[:, j] = top[0]
    him[:, j] = top[1]
    R[:, :, j] = torch.where(active[:, None, None],
                             torch.stack([hre[:, :k], him[:, :k]], dim=2),
                             R[:, :, j])

    gj = (g[:, j, 0], g[:, j, 1])
    g_top = _cmul((c, 0.0 * c), gj)
    g_bot = (-(s[0] * gj[0] + s[1] * gj[1]),
             -(s[0] * gj[1] - s[1] * gj[0]))
    g_new = torch.stack([torch.stack(g_top, dim=1),
                         torch.stack(g_bot, dim=1)], dim=1)
    g[:, j:j + 2] = torch.where(active[:, None, None], g_new, g[:, j:j + 2])
    rn2_new = g_bot[0] ** 2 + g_bot[1] ** 2
    rn2.copy_(torch.where(active, rn2_new, rn2))
    # the first step resolves the stiffness-lift components of the
    # residual; the target is re-anchored at what is left after it
    if anchor:
        anc = torch.maximum(torch.sqrt(rn2), 1e-13 * beta0)
        tol2.copy_(torch.where(active, (tol_rel * anc) ** 2, tol2))


givens_step_reference.cuda_calls = 0


def _check(name, tensors, shapes, dev) -> None:
    """Raise unless every tensor lies on ``dev`` with its shape in
    ``shapes``, contiguous, f64 (``active`` bool, ``j_fin`` int64), and
    those the kernels move in 16-byte units (``_ALIGNED``) 16-byte
    aligned."""
    for key, t in tensors.items():
        want = shapes[key]
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, not {dev}.")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, not {want}.")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous.")
        dtype = {"active": torch.bool, "j_fin": torch.int64}.get(
            key, torch.float64)
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {dtype}.")
        if key in _ALIGNED and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned.")


# what the kernels stage or store in 16-byte units
_ALIGNED = ("hre", "him", "cs", "sn", "R", "g")


class _Cycle:
    """A cycle's state tensors (``STATE_KEYS``) as checked at its first
    step: their ids, weak references whose callback forgets the cycle when
    one of them is freed (so that the ids stay theirs), the ``_State`` the
    launcher reads, their device and its index.  A step whose state is the
    same eight tensors skips their checks: none of them changes shape,
    type or place in a cycle."""

    __slots__ = ("ids", "refs", "L", "k", "dev", "index", "state", "ref")

    def __init__(self, tensors):
        self.ids = tuple(map(id, tensors))
        self.refs = tuple(weakref.ref(t, _forget) for t in tensors)
        self.L, self.k = tensors[0].shape
        self.dev = tensors[0].device
        self.index = self.dev.index
        self.state = _State(*(t.data_ptr() for t in tensors), self.L,
                            self.k)
        self.ref = ctypes.byref(self.state)

    def holds(self, tensors) -> bool:
        """Whether ``tensors`` are this cycle's state, object for object."""
        return tuple(map(id, tensors)) == self.ids


_cycle = None       # the last cycle checked, while its tensors live


def _forget(ref) -> None:
    global _cycle
    if _cycle is not None and any(ref is r for r in _cycle.refs):
        _cycle = None


def _cycle_of(state, dev) -> _Cycle:
    """The ``_Cycle`` of the state tensors ``state``: the last one if they
    are its tensors, else a new one, checked to lie on ``dev``."""
    global _cycle
    if _cycle is not None and _cycle.holds(state):
        return _cycle
    cs = state[0]
    L, k = cs.shape
    if not 0 < k <= _kmax:
        raise ValueError(f"givens_step_cuda: k = {k} (1 <= k <= {_kmax}: "
                         "the kernels' widest bucket).")
    _check("givens_step_cuda", dict(zip(STATE_KEYS, state)),
           {"cs": (L, k), "sn": (L, k, 2), "R": (L, k, k, 2),
            "g": (L, k + 1, 2), "rn2": (L,), "tol2": (L,), "beta0": (L,),
            "tol_rel": (L,)}, dev)
    _cycle = _Cycle(state)
    return _cycle


def _fits(t, shape, dtype, index) -> bool:
    return (t.dtype is dtype and t.get_device() == index and t.shape == shape
            and t.is_contiguous())


def _launch(fn, index, *args) -> int:
    """``fn(*args, stream)`` on the card ``index`` and its current stream
    (a handle read through the binding torch's own generated code uses)."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch.cuda.current_device() == index:
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def givens_step_cuda(hre, him, hlast, cs, sn, R, g, rn2, tol2, beta0,
                     tol_rel, active, j: int, anchor: bool) -> None:
    """``givens_step_reference`` through the CUDA kernel: every tensor f64
    (``active`` bool), contiguous and on one CUDA device, hre, him, cs, sn,
    R and g 16-byte aligned, k no more than the library's
    ``fgmres_lsq_kmax()``."""
    if not hre.is_cuda:
        raise ValueError("givens_step_cuda needs CUDA tensors.")
    if _lib is None:
        build()
    c = _cycle_of((cs, sn, R, g, rn2, tol2, beta0, tol_rel), hre.device)
    L, k, index = c.L, c.k, c.index
    if not 0 <= j < k:
        raise ValueError(f"givens_step_cuda: step {j} of k = {k}.")
    f64 = torch.float64
    p_re, p_im = hre.data_ptr(), him.data_ptr()
    if not (_fits(hre, (L, k + 1), f64, index)
            and _fits(him, (L, k + 1), f64, index)
            and _fits(hlast, (L,), f64, index)
            and _fits(active, (L,), torch.bool, index)
            and not (p_re | p_im) % 16):
        _check("givens_step_cuda",
               {"hre": hre, "him": him, "hlast": hlast, "active": active},
               {"hre": (L, k + 1), "him": (L, k + 1), "hlast": (L,),
                "active": (L,)}, c.dev)
    if L == 0:   # nothing to launch
        return
    rc = _launch(_lib.givens_step_launch, index, c.ref, p_re, p_im,
                 hlast.data_ptr(), active.data_ptr(), int(j), int(anchor))
    if rc != 0:
        raise RuntimeError(f"givens_step kernel launch failed: cudaError "
                           f"{rc}.")
    givens_step_cuda.launches += 1


givens_step_cuda.launches = 0


def givens_step(hre, him, hlast, cs, sn, R, g, rn2, tol2, beta0, tol_rel,
                active, j: int, anchor: bool) -> None:
    """Step ``j`` of the Givens least squares in place
    (``givens_step_reference``): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    (givens_step_cuda if hre.is_cuda else givens_step_reference)(
        hre, him, hlast, cs, sn, R, g, rn2, tol2, beta0, tol_rel, active, j,
        anchor)


# ---------------------------------------------------------------------------
# K7b: the cycle's back-substitution
# ---------------------------------------------------------------------------

def backsub_reference(R, g, j_fin):
    """y (L, k, 2) with R y = g on each lane's first ``j_fin`` rows: g's
    rows past a lane's last step are taken as 0, where R is the identity,
    so y is 0 there.  R (L, k, k, 2), g (L, k+1, 2) f64, j_fin (L,) int64."""
    if R.is_cuda:
        backsub_reference.cuda_calls += 1
    L, k = R.shape[:2]
    tiny = _TINY
    rows_on = torch.arange(k, device=R.device)[None, :] < j_fin[:, None]
    g = torch.where(rows_on[..., None], g[:, :k], 0.0)
    y = torch.zeros(L, k, 2, dtype=R.dtype, device=R.device)
    for t in range(k):
        l = k - 1 - t
        acc_re = _dot_in_order(R[:, l, :, 0], y[..., 0]) \
            - _dot_in_order(R[:, l, :, 1], y[..., 1])
        acc_im = _dot_in_order(R[:, l, :, 0], y[..., 1]) \
            + _dot_in_order(R[:, l, :, 1], y[..., 0])
        num = (g[:, l, 0] - acc_re, g[:, l, 1] - acc_im)
        den = R[:, l, l, 0] ** 2 + R[:, l, l, 1] ** 2
        yl = _cmul(num, (R[:, l, l, 0] / torch.clamp(den, min=tiny),
                         -R[:, l, l, 1] / torch.clamp(den, min=tiny)))
        y[:, l, 0] = yl[0]
        y[:, l, 1] = yl[1]
    return y


backsub_reference.cuda_calls = 0


def backsub_cuda(R, g, j_fin):
    """``backsub_reference`` through the CUDA kernel: R and g f64 and
    16-byte aligned, j_fin int64, contiguous and on one CUDA device, k no
    more than the library's ``fgmres_lsq_kmax()``.  R and g of the cycle
    whose steps ran last are not checked again."""
    if not R.is_cuda:
        raise ValueError("backsub_cuda needs CUDA tensors.")
    if _lib is None:
        build()
    c = _cycle
    p_R, p_g = R.data_ptr(), g.data_ptr()
    if c is not None and c.ids[2] == id(R) and c.ids[3] == id(g):
        L, k, index = c.L, c.k, c.index
    else:
        L, k = R.shape[:2]
        index = R.get_device()
        if not 0 < k <= _kmax:
            raise ValueError(f"backsub_cuda: k = {k} (1 <= k <= {_kmax}: "
                             "the kernels' widest bucket).")
        f64 = torch.float64
        if not (_fits(R, (L, k, k, 2), f64, index)
                and _fits(g, (L, k + 1, 2), f64, index)
                and not (p_R | p_g) % 16):
            _check("backsub_cuda", {"R": R, "g": g},
                   {"R": (L, k, k, 2), "g": (L, k + 1, 2)}, R.device)
    if not _fits(j_fin, (L,), torch.int64, index):
        _check("backsub_cuda", {"j_fin": j_fin}, {"j_fin": (L,)}, R.device)
    y = torch.empty(L, k, 2, dtype=R.dtype, device=R.device)
    if L == 0:   # nothing to launch
        return y
    rc = _launch(_lib.backsub_launch, index, p_R, p_g, j_fin.data_ptr(),
                 y.data_ptr(), L, k)
    if rc != 0:
        raise RuntimeError(f"backsub kernel launch failed: cudaError {rc}.")
    backsub_cuda.launches += 1
    return y


backsub_cuda.launches = 0


def backsub(R, g, j_fin):
    """The cycle's back-substitution (``backsub_reference``): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if R.is_cuda:
        return backsub_cuda(R, g, j_fin)
    return backsub_reference(R, g, j_fin)


# ---------------------------------------------------------------------------
# the kernels' checks (tests, chip_smoke.py)
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def compare(calls) -> tuple[int, float]:
    """Run each recorded call ((name, arguments) of ``givens_step`` or
    ``backsub``, on a CUDA device) through the kernel and the plain version, each on its own copy
    of the arguments.  Returns the number of calls whose outputs differ in
    any bit and the largest absolute difference of an output."""
    differ, worst = 0, 0.0
    for name, args in calls:
        a = [x.clone() if torch.is_tensor(x) else x for x in args]
        b = [x.clone() if torch.is_tensor(x) else x for x in args]
        if name == "givens_step":
            givens_step_cuda(*a)
            givens_step_reference(*b)
            outs = list(zip(a[3:9], b[3:9]))      # cs, sn, R, g, rn2, tol2
        else:
            outs = [(backsub_cuda(*a), backsub_reference(*b))]
        differ += not all(torch.equal(_bits(x), _bits(y)) for x, y in outs)
        worst = max([worst] + [float((x - y).abs().max()) for x, y in outs])
    return differ, worst


# lane kinds of ``synthetic_cycle``, by lane % 8: 0 a = 0 at every step
# (no CGS coefficients), 1 b = 0 (a happy breakdown at every step), 2 both
# zero, 3 inactive from a seeded step on, 4 entries near 1e-295 (their
# squares underflow: the clamped branches), 5-7 plain
SYNTHETIC_KINDS = ("a=0", "b=0", "both zero", "inactive", "underflow",
                   "plain", "plain", "plain")
# ``givens_step``'s state arguments, in order
STATE_KEYS = ("cs", "sn", "R", "g", "rn2", "tol2", "beta0", "tol_rel")


def synthetic_cycle(L: int, k: int, seed: int = 0, device="cpu"):
    """A seeded cycle of k Givens steps on L lanes, of the lane kinds of
    ``SYNTHETIC_KINDS``.  Returns (state, steps, H, beta0, j_fin): the
    starting state {"cs", "sn", "R", "g", "rn2", "tol2", "beta0",
    "tol_rel"} as ``_pgmres_cycle`` sets it up, the inputs {"hre", "him",
    "hlast", "active"} of step j = 0..k-1, the lanes' complex upper
    Hessenberg matrices H (L, k+1, k) as numpy, their beta0 and their
    step counts j_fin as numpy.  Step j is ``givens_step(hre, him, hlast,
    *(state[key] for key in STATE_KEYS), active, j, j == 0)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kind = np.arange(L) % 8
    H = (rng.standard_normal((L, k + 1, k))
         + 1j * rng.standard_normal((L, k + 1, k)))
    H = np.triu(H, -1)
    sub = np.abs(rng.standard_normal((L, k))) + 0.1       # h_{j+1, j} >= 0
    for jj in range(k):
        H[:, jj + 1, jj] = np.where(kind == 1, 0.0, sub[:, jj])
    H[kind == 0] = np.tril(H[kind == 0], -1)             # only h_{j+1, j}
    H[kind == 2] = 0.0
    H[kind == 4] *= 1e-295
    beta0 = np.abs(rng.standard_normal(L)) + 0.5
    j_fin = np.full(L, k)
    j_fin[kind == 3] = rng.integers(0, k, size=int((kind == 3).sum()))

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    R = torch.zeros(L, k, k, 2, dtype=torch.float64, device=device)
    R[..., 0] = torch.eye(k, dtype=torch.float64, device=device)
    g = torch.zeros(L, k + 1, 2, dtype=torch.float64, device=device)
    g[:, 0, 0] = t(beta0)
    state = {"cs": torch.ones(L, k, dtype=torch.float64, device=device),
             "sn": torch.zeros(L, k, 2, dtype=torch.float64, device=device),
             "R": R, "g": g, "rn2": t(beta0 * beta0),
             "tol2": torch.zeros(L, dtype=torch.float64, device=device),
             "beta0": t(beta0),
             "tol_rel": t(10.0 ** rng.uniform(-12, -6, L))}
    steps = []
    for jj in range(k):
        col = np.zeros((L, k + 1), complex)
        col[:, :jj + 1] = H[:, :jj + 1, jj]
        steps.append({"hre": t(col.real), "him": t(col.imag),
                      "hlast": t(H[:, jj + 1, jj].real),
                      "active": t(jj < j_fin, torch.bool)})
    return state, steps, H, beta0, j_fin
