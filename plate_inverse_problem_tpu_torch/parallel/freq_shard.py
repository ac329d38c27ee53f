"""Frequency-axis (and DOF-axis) sharding of the FRF sweep over
``torch.distributed`` (port of the JAX package's ``parallel/freq_shard.py``).

One rank drives one device.  The ranks form a (freq, dof) mesh, rank =
i_freq * dof + i_dof as the JAX package reshapes its device list: the
ranks of one ``dof`` group share a frequency slice, and the ``freq``
groups split the sweep.  Collectives run over NCCL on the card and over
gloo on the CPU (or, on request, on the card: two ranks on one card).

Every cross-rank combine is one pattern, ``Mesh.gather``: each rank writes
its part into its own slot of a zero-filled stack, one ``all_reduce(SUM)``
fills the stack on every rank (adding zeros is exact), and each rank then
reads the slots in rank order — a concatenation for the FRF, a sum for the
loss, the gradient and the Gauss-Newton partials.  The result is the same
bits on every rank and in every run, whatever algorithm the backend picks.

The dof axis partitions what the JAX package places over ``dof``
(``opdata_shardings``), its memory as well as its products: the first dof
mesh a Problem meets replaces each such entry of its operator data by
this rank's share and drops the whole one.  By rows (``RowShard``, whole
blocks of ``ops.dense.fixed_blocks``; a rank may own none): the dense
inverses (``invK64``, the dense tier's preconditioner, the JAX package's
f32 ``invK32`` where a Problem runs on its operator data, and
``mg_Kcinv``, the two-grid's coarse inverse), each rank multiplying by
its blocks, the group's slot ``all_reduce`` filling in the product; and
the band basis ``W64``, gathered whole for each sweep.  By block rows
(``ops.mg.TwoGridRows``, whole groups of ``fixed_blocks(nb, 1)``): the
two-grid's band ``mg_band0`` with its K1 pack, its prolongation
``mg_Pt`` and diagonal ``mg_dinv``; the cycle keeps its vectors on the
rank's rows, with a halo exchange before each K1 launch on the rank's
window, and gathers the coarse residual and its output.  A dof axis
wider than the band's groups keeps those three whole, as the JAX package
keeps an axis its dof axis does not divide: each rank runs the whole
cycle.  Every partitioned product makes the
whole one's calls on the rank's blocks, so the group's ranks carry the
unsharded sweep's bits and their FGMRES decisions stay in lockstep.  A
placed Problem serves only the collective calls: its unsharded entry
points raise.  Every collective has the process group's timeout: a rank
that diverges raises instead of hanging.

Pad frequencies (``shard_frequencies`` repeats the last one up to a
multiple of the freq axis) are computed by ``sharded_fr_function``, whose
caller slices them off, and skipped by the training and Gauss-Newton
steps, which weight every true frequency equally as the JAX masks do.
"""
from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.problem import (
    ResidualFunction,
    _as_tensor,
    _dof_placed_error,
    _has_adjoint_hooks,
    _numpy,
    _re_im,
    _ref_abs,
    _split_ref,
)
from ..ops.band_kernel import pack_band_tiles
from ..ops.dense import blocked_matmul, fixed_blocks, owned_blocks
from ..ops.mg import TwoGridRows

# seconds a collective waits for its peers before it raises
TIMEOUT_S = 300.0
# opdata keys the dof axis partitions (the JAX package's): by rows, the
# dense tier's inverse (the port's f64 one, or the JAX package's f32 one),
# the two-grid's coarse inverse and the band basis; by block rows, the
# two-grid's band and prolongation, with the diagonal's rows
_ROW_SHARDED_2D = ("invK64", "invK32", "mg_Kcinv", "W64")
_BLOCK_SHARDED = ("mg_band0", "mg_Pt")
_PARTITIONED = _ROW_SHARDED_2D + _BLOCK_SHARDED + ("mg_dinv",)


def _device(device) -> torch.device:
    """``"cuda"`` is this rank's card, ``cuda:{LOCAL_RANK}``."""
    if str(device) == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a and b name one device, a CUDA device without an index
    being the current one (where torch puts its tensors)."""
    def full(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return a.type == b.type and (a == b or full(a) == full(b))


def init(backend: str | None = None, device="cuda", *,
         init_method: str = "env://", rank: int | None = None,
         world_size: int | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``backend`` None: NCCL for a CUDA device, gloo for the CPU; gloo may
    be asked for on the card (several ranks on one card).  ``init_method``
    "env://" reads torchrun's variables; a ``file://`` or
    ``tcp://localhost:<port>`` store needs ``rank`` and ``world_size``.
    No fallback: a CUDA device without CUDA, or a failed init, raises."""
    dev = _device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        torch.cuda.set_device(dev)
    kw = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timedelta(seconds=TIMEOUT_S), **kw)
    return dev


class Mesh:
    """The (freq, dof) layout of the process group: ``shape``, this rank's
    ``coords``, its ``device`` and the two axis groups it belongs to (none
    in a world of one without a process group, where no collective runs).
    ``collectives`` counts this mesh's all_reduces; with ``timed`` set,
    ``collective_s`` adds up their seconds, each timed alone between two
    synchronisations of the device (off by default: it stalls the host
    twice an all_reduce, and the dof axis runs one a preconditioner
    apply)."""

    def __init__(self, n_freq: int, n_dof: int, rank: int, device,
                 groups: dict):
        self.shape = {"freq": n_freq, "dof": n_dof}
        self.coords = {"freq": rank // n_dof, "dof": rank % n_dof}
        self.device = device
        self.groups = groups
        self.collective_s = 0.0
        self.collectives = 0
        self.timed = False
        # (problem, core, opdata with this rank's row blocks) by id(problem)
        self._placed = {}

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reduce(self, buf: torch.Tensor, axis: str) -> None:
        """In-place ``all_reduce(SUM)`` of ``buf`` over this rank's
        ``axis`` group (nothing without a process group)."""
        group = self.groups.get(axis)
        if group is None:
            return
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        dist.all_reduce(torch.view_as_real(buf) if buf.is_complex() else buf,
                        op=dist.ReduceOp.SUM, group=group)
        if self.timed:
            self._sync()
            self.collective_s += time.perf_counter() - t0
        self.collectives += 1

    def gather(self, part: torch.Tensor, axis: str = "freq") -> torch.Tensor:
        """(size, *part.shape): every rank of the ``axis`` group's part in
        its slot, the same bits on every rank."""
        buf = part.new_zeros((self.shape[axis],) + tuple(part.shape))
        buf[self.coords[axis]] = part
        self.reduce(buf, axis)
        return buf


def make_mesh(n_devices: int | None = None, dof_axis: int = 1,
              device=None) -> Mesh:
    """Mesh with a ``freq`` axis (and optional ``dof`` axis) over the
    process group: ``dof_axis`` ranks share each frequency slice.

    ``n_devices`` is the world size (one rank drives one device; another
    count raises).  ``device``: this rank's, ``cuda:{LOCAL_RANK}`` unless
    given ("cpu" on the CPU).  Without a process group the mesh is a world
    of one on the Problem's device: the same code path, no collective.
    Every rank calls this with the same arguments (it creates the axis
    groups, which is collective)."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for in a world of "
                         f"{world} ranks (one rank drives one device)")
    if dof_axis < 1 or n % dof_axis:
        raise ValueError(f"{n} devices not divisible by dof_axis={dof_axis}")
    nd, nf = dof_axis, n // dof_axis
    groups = {}
    if dist.is_initialized():
        # every rank creates every group, in one order
        dof_g = [dist.new_group([i * nd + j for j in range(nd)])
                 for i in range(nf)]
        freq_g = [dist.new_group([i * nd + j for i in range(nf)])
                  for j in range(nd)]
        groups = {"dof": dof_g[rank // nd], "freq": freq_g[rank % nd]}
        device = _device("cuda" if device is None else device)
    elif device is not None:
        device = _device(device)
    return Mesh(nf, nd, rank, device, groups)


class ShardedFreqs(NamedTuple):
    """``padded``: the frequencies padded to a multiple of the freq axis
    (repeating the last one); ``local``: this rank's equal slice of them."""
    padded: torch.Tensor
    local: torch.Tensor


def shard_frequencies(mesh: Mesh, freqs) -> ShardedFreqs:
    """Pad ``freqs`` to a multiple of the freq-axis size by repeating the
    last entry (callers slice the result back) and cut this rank's slice."""
    f = torch.as_tensor(np.asarray(_numpy(freqs), np.float64),
                        device=mesh.device)
    rem = (-f.shape[0]) % mesh.shape["freq"]
    if rem:
        f = torch.cat([f, f[-1:].repeat(rem)])
    return ShardedFreqs(f, f[_rank_slice(mesh, f.shape[0])])


def _rank_slice(mesh: Mesh, F: int) -> slice:
    """This rank's slice of F frequencies in the JAX layout (F padded to a
    multiple of the freq axis, an equal slice each), cut at F: of padded
    frequencies the rank's whole slice, of the true ones its true
    frequencies (the training and Gauss-Newton steps skip the pad lanes
    rather than compute and mask them)."""
    s = -(-F // mesh.shape["freq"])
    lo = min(F, mesh.coords["freq"] * s)
    return slice(lo, min(F, lo + s))


def row_range(n: int, n_dof: int, i_dof: int) -> tuple[int, int]:
    """Rows [lo, hi) of n that rank ``i_dof`` of a dof axis of ``n_dof``
    owns: whole blocks of ``ops.dense.fixed_blocks(n)`` (the blocks the
    dense apply multiplies by, one GEMM each), split as evenly as they
    allow."""
    return owned_blocks(fixed_blocks(n), n_dof, i_dof)


def band_splits(nb: int, n_dof: int) -> bool:
    """Whether a dof axis of ``n_dof`` can split a band of nb block rows:
    every rank must own whole groups of ``fixed_blocks(nb, 1)``, and there
    are at most 8."""
    return len(fixed_blocks(nb, 1)) - 1 >= n_dof


def band_range(nb: int, n_dof: int, i_dof: int) -> tuple[int, int]:
    """Block rows [q0, q1) of a band of nb that rank ``i_dof`` of a dof
    axis of ``n_dof`` owns: whole groups of ``fixed_blocks(nb, 1)`` (the
    groups the prolongation's GEMMs run on, at most 8), split as evenly
    as they allow.  Every rank must own some: fewer groups than ranks
    raise (``opdata_shardings`` then keeps the two-grid whole)."""
    groups = len(fixed_blocks(nb, 1)) - 1
    if not band_splits(nb, n_dof):
        raise ValueError(
            f"the two-grid band has nb = {nb} block rows in {groups} groups, "
            f"fewer than the {n_dof} ranks of the dof axis: each rank must "
            "own whole groups of it; use a smaller dof axis")
    return owned_blocks(fixed_blocks(nb, 1), n_dof, i_dof)


class RowShard:
    """Rows [lo, hi) of a dense (n, m) entry that one rank of a dof group
    owns (a dense inverse, or the band basis ``W64``): ``rows`` is a copy
    of them in the full matrix's layout (the group's other ranks hold the
    rest).  Bound to a mesh (``bind``), ``apply_t(x)`` is ``x @ inv.T``
    for (..., n) rows x of a square inverse: this rank's blocks of the
    product (``ops.dense.dense_apply``'s GEMMs on its blocks), filled in
    by the group's slot all_reduce, so every rank of the group holds the
    same bits, those of the whole apply; ``whole()`` is the whole entry (a
    transient, every rank's rows in their slots).  Unbound, as the placed
    Problem's own operator data holds it, both raise: alone, a rank has
    only its rows.  ``RowShard.applies`` counts the products (one an
    apply, a GEMM an owned block) over every instance."""

    applies = 0
    ndim = 2

    def __init__(self, rows: torch.Tensor, lo: int, shape: tuple, dof: tuple,
                 mesh: Mesh | None = None):
        self.rows = rows
        self.lo, self.hi = lo, lo + rows.shape[0]
        self.shape = tuple(shape)
        self.dof = dof                  # (dof axis size, this rank's index)
        self._mesh = mesh

    @classmethod
    def own(cls, full: torch.Tensor, n_dof: int, i_dof: int) -> "RowShard":
        """Rank ``i_dof`` of ``n_dof``'s rows of ``full`` (``row_range``),
        copied in the layout the view ``full[lo:hi]`` has: a row-major
        entry's rows are contiguous, a column-major one's (a host splu's
        solve against the identity) strided, so the copy's GEMMs are the
        view's."""
        n, m = full.shape
        lo, hi = row_range(n, n_dof, i_dof)
        col_major = full.stride(0) < full.stride(1)
        rows = torch.empty_strided((hi - lo, m),
                                   (1, hi - lo) if col_major else (m, 1),
                                   dtype=full.dtype, device=full.device)
        rows.copy_(full[lo:hi])
        return cls(rows, lo, full.shape, (n_dof, i_dof))

    @property
    def dtype(self) -> torch.dtype:
        return self.rows.dtype

    def bind(self, mesh: Mesh) -> "RowShard":
        """The same rows, their products reduced over ``mesh``'s dof group
        (the same dof layout)."""
        return RowShard(self.rows, self.lo, self.shape, self.dof, mesh)

    def _reduce(self, buf: torch.Tensor) -> torch.Tensor:
        if self._mesh is None:
            raise _dof_placed_error(*self.dof)
        self._mesh.reduce(buf, "dof")
        return buf

    def apply_t(self, x: torch.Tensor) -> torch.Tensor:
        if self._mesh is None:
            raise _dof_placed_error(*self.dof)
        y = x.new_zeros(x.shape[:-1] + (self.shape[0],))
        y[..., self.lo:self.hi] = blocked_matmul(x, self.rows, self.lo,
                                                 self.shape[0])
        RowShard.applies += 1
        return self._reduce(y)

    def whole(self) -> torch.Tensor:
        full = self.rows.new_zeros(self.shape)
        full[self.lo:self.hi] = self.rows
        return self._reduce(full)


def _own_twogrid(od: dict, pack, layout, n_dof: int, i_dof: int) -> dict:
    """Rank ``i_dof`` of ``n_dof``'s block rows [q0, q1) (``band_range``)
    of the two-grid: ``mg_band0``'s rows and their window pack (packed from
    those rows alone), with ``mg_Pt``'s block rows and ``mg_dinv``'s rows
    [q0 b, min(n, q1 b)), as {key: entry}: a ``TwoGridRows`` under
    ``mg_band0``, and None under ``mg_Pt`` and ``mg_dinv``, which the
    placed operator dict drops (the rank's rows of them live in the
    ``TwoGridRows``)."""
    band, Pt, dinv = od["mg_band0"], od["mg_Pt"], od["mg_dinv"]
    nb, b = band.shape[:2]
    bounds = tuple(band_range(nb, n_dof, j)[0] for j in range(n_dof)) + (nb,)
    q0, q1 = bounds[i_dof], bounds[i_dof + 1]
    lo, hi = q0 * b, min(layout.n, q1 * b)
    band_rows, Pt_rows = band[q0:q1].clone(), Pt[q0:q1].clone()
    dinv_rows = dinv[lo:hi].clone()
    part = TwoGridRows(band=band_rows,
                       pack=pack_band_tiles(band_rows, layout, pack.tile,
                                            q0=q0),
                       Pt=Pt_rows, dinv=dinv_rows, bounds=bounds,
                       rank=i_dof,
                       unbound=lambda: _dof_placed_error(n_dof, i_dof))
    return {"mg_band0": part, "mg_Pt": None, "mg_dinv": None}


def opdata_shardings(mesh: Mesh, opdata) -> dict:
    """Placement of each operator-data entry, as a partition spec tuple —
    the JAX package's (its ``opdata_shardings``): ``("dof", None)`` for
    the rows of a dense inverse (``invK32``, the port's f64 ``invK64``,
    ``mg_Kcinv``) and of the band basis ``W64``; the block-row axis of the
    two-grid's ``mg_band0`` and ``mg_Pt`` (``("dof", None, None)``) and
    its diagonal ``mg_dinv`` (``("dof",)``); ``()`` for a replicated entry
    (everything else, and everything on a dof axis of 1).  Where the JAX
    package needs the leading axis to be a multiple of the dof axis (its
    arrays split into equal parts), the port splits by whole blocks
    (``row_range``, ``band_range``), so it also places an axis that d does
    not divide.  A band of fewer block-row groups than ranks
    (``band_splits``) stays whole with its P and diagonal, as the JAX
    package keeps an axis d does not divide: every rank then runs the
    whole cycle on the whole K1 pack (its coarse solve still by the
    coarse inverse's owned rows)."""
    nd = mesh.shape["dof"]
    band = opdata.get("mg_band0")
    if band is not None and not band_splits(band.shape[0], nd):
        band = None

    def place(key, v):
        if nd <= 1 or v.ndim == 0 or v.shape[0] <= 1:
            return ()
        if key in _ROW_SHARDED_2D and v.ndim == 2:
            return ("dof", None)
        if band is not None and key in _BLOCK_SHARDED and v.ndim >= 2:
            return ("dof",) + (None,) * (v.ndim - 1)
        if band is not None and key == "mg_dinv" and v.ndim == 1:
            return ("dof",)
        return ()

    return {k: place(k, v) for k, v in opdata.items()}


def _placed(problem, mesh: Mesh):
    """(core, opdata with this rank's shares bound to the mesh) of
    ``problem``, on the mesh's device; built once per (Problem, mesh).

    The first mesh whose dof axis partitions an entry places the Problem
    (``Problem._place_rows``): each dense inverse and ``W64`` becomes this
    rank's ``RowShard``, the two-grid's band, its K1 pack, P and diagonal
    this rank's block rows (``_own_twogrid``), and the whole entries are
    dropped, so the rank keeps its share of each (``opdata_shardings``),
    and the Problem then serves only collective calls on meshes of that
    dof layout.  A dof-1 mesh leaves it untouched; what such a mesh made
    serves until the Problem is placed.
    """
    if mesh.device is not None and not _same_device(problem.device,
                                                    mesh.device):
        raise ValueError(f"the Problem lives on {problem.device}, the mesh "
                         f"rank on {mesh.device}")
    layout = (mesh.shape["dof"], mesh.coords["dof"])
    specs = opdata_shardings(mesh, problem.operator_data())

    def own(od, pack):
        out = {k: RowShard.own(od[k], *layout) for k in _ROW_SHARDED_2D
               if specs.get(k)}
        if specs.get("mg_band0"):
            out |= _own_twogrid(od, pack, problem._band_layout, *layout)
        return out

    core, od = problem._place_rows(layout, own)
    hit = mesh._placed.get(id(problem))
    if hit is not None:
        return hit[1:]
    if any(isinstance(v, (RowShard, TwoGridRows)) for v in od.values()):
        def stack(part):
            return mesh.gather(part, "dof")

        od = {k: v.bind(mesh) if isinstance(v, RowShard)
              else v.bind(stack) if isinstance(v, TwoGridRows) else v
              for k, v in od.items()}
    # unplaced, the mesh uses the Problem's own dict: a later placement
    # replaces the entries there too, and nothing keeps the whole ones
    mesh._placed[id(problem)] = (problem, core, od)
    return core, od


def _sum_slots(stack: torch.Tensor) -> torch.Tensor:
    """Sum of a gathered stack's slots in rank order."""
    tot = stack[0].clone()
    for part in stack[1:]:
        tot += part
    return tot


def sharded_fr_function(problem, mesh: Mesh):
    """Sharded version of ``Problem.getFRFunction``: ``fn(freqs, params)``
    with ``freqs`` padded to a multiple of the freq axis (a
    ``ShardedFreqs`` or the padded array) returns the whole padded FRF on
    every rank (callers slice off the padding); each rank sweeps its
    slice."""
    core, od = _placed(problem, mesh)
    dev = problem.device

    def fn(freqs, params):
        if isinstance(freqs, ShardedFreqs):
            freqs = freqs.padded
        f = _as_tensor(_numpy(freqs), dev)
        nf = mesh.shape["freq"]
        if f.shape[0] % nf:
            raise ValueError(f"{f.shape[0]} frequencies are not a multiple "
                             f"of the freq axis ({nf}): pad them with "
                             "shard_frequencies")
        with torch.no_grad():
            fr = core(f[_rank_slice(mesh, f.shape[0])],
                      _as_tensor(_numpy(params), dev), od)
        return mesh.gather(fr).reshape(-1)

    return fn


def sharded_train_step(problem, mesh: Mesh, loss_type: str = "MSE_LOG_AFC",
                       lr: float = 1e-3):
    """One inverse-iteration step over the mesh — loss + gradient +
    parameter update.  Returns ``step(freqs, ref_fr, params) -> (loss,
    grad, new_params)`` taking the *unpadded* frequencies and reference:
    each rank differentiates the sum of its true frequencies' terms (the
    primal and one adjoint sweep, ``_ImplicitSweep``), the partial sums are
    gathered and added in rank order, and the mean over the true
    frequencies weights each of them equally whatever the rank count.
    ``loss_type`` "MSE_LOG_AFC" is the log-magnitude error, any other the
    squared complex error (the JAX step's two cases)."""
    core, od = _placed(problem, mesh)
    dev = problem.device

    def term(fr, ref):
        if loss_type == "MSE_LOG_AFC":
            return (torch.log(torch.abs(fr)) - torch.log(_ref_abs(ref))) ** 2
        re, im = _re_im(fr)
        return (re - ref[..., 0]) ** 2 + (im - ref[..., 1]) ** 2

    def step(freqs, ref, params):
        f = _as_tensor(_numpy(freqs), dev)
        rs = _split_ref(ref, dev)
        th = _as_tensor(_numpy(params), dev).detach()
        F = f.shape[0]
        live = _rank_slice(mesh, F)
        part = th.new_zeros(1 + th.shape[0])
        if live.stop > live.start:
            x = th.clone().requires_grad_(True)
            v = term(core(f[live], x, od), rs[live]).sum()
            (g,) = torch.autograd.grad(v, x)
            part = torch.cat([v.detach()[None], g])
        tot = _sum_slots(mesh.gather(part)) / F
        loss, g = tot[0], tot[1:]
        return loss, g, th - lr * g

    return step


def sharded_gn_step(problem, mesh: Mesh, kind: str = "log_afc",
                    damping: float = 0.0, jac_mode: str = "auto",
                    freq_chunk: int | None = None):
    """One Gauss-Newton iteration over the mesh — the multi-rank version of
    ``ResidualFunction.value_and_jac`` + normal equations.

    Each rank forms (|r|^2, J^T r, J^T J) over its true frequencies with
    the port's ``ResidualFunction`` in ``jac_mode`` 'adjoint' (the primal
    and one adjoint sweep, p solve-free tangents; the mixed engine's hooks)
    or 'fwd' (the primal and one tangent sweep of p x F lanes); 'auto'
    takes adjoint where the core has its hooks.  ``freq_chunk``: lanes per
    rank per call (None: the whole slice, or for 'fwd' the Problem's
    memory policy, ``_auto_freq_chunk``); the chunks' partial sums add up
    on the host in f64 in frequency order.  The ranks' partials are
    gathered and added in rank order, and the damped normal solve runs on
    the host in f64: Marquardt damping (the diagonal times 1 + damping),
    a ~zero-diagonal (unidentifiable) direction pinned to dx_i = 0.

    Returns ``step(freqs, ref_fr, params, damping=None) -> (rsq,
    new_params)`` taking the *unpadded* frequencies and reference;
    ``damping`` overrides the constructor's per call (it touches only the
    host solve).  ``step.jac_mode`` is the resolved mode."""
    _damping = damping
    core, od = _placed(problem, mesh)
    dev = problem.device
    if kind not in ("log_afc", "afc"):
        raise ValueError(f"unsupported sharded-GN residual kind {kind!r}")
    adjoint_ok = _has_adjoint_hooks(core)
    if jac_mode == "auto":
        jac_mode = "adjoint" if adjoint_ok else "fwd"
    elif jac_mode == "adjoint" and not adjoint_ok:
        raise ValueError("jac_mode='adjoint' needs a core exposing the "
                         "adjoint hooks (mixed-engine cores do).")
    elif jac_mode not in ("adjoint", "fwd"):
        raise ValueError(f"Unknown jac_mode {jac_mode!r}.")

    def partials(f, ref, th):
        """[|r|^2, J^T r, J^T J (row-major)] over this rank's frequencies."""
        p = th.shape[0]
        chunk = freq_chunk
        if chunk is None and jac_mode == "fwd":
            chunk = problem._auto_freq_chunk(lanes=1 + p)
        chunk = chunk or max(1, f.shape[0])
        acc = np.zeros(1 + p + p * p)
        for lo in range(0, f.shape[0], chunk):
            rf = ResidualFunction(core, od, f[lo:lo + chunk],
                                  ref[lo:lo + chunk], kind,
                                  jac_mode=jac_mode)
            r, J = (_numpy(a) for a in rf.value_and_jac(th))
            acc += np.concatenate([[r @ r], J.T @ r, (J.T @ J).ravel()])
        return acc

    def step(freqs, ref, params, damping: float | None = None):
        lam = float(_damping if damping is None else damping)
        f = _numpy(freqs).astype(np.float64)
        ref = _numpy(ref)
        th = _as_tensor(_numpy(params), dev)
        p = th.shape[0]
        live = _rank_slice(mesh, f.shape[0])
        part = partials(f[live], ref[live], th)
        tot = _numpy(_sum_slots(mesh.gather(torch.as_tensor(part,
                                                            device=dev))))
        rsq, Jtr, A = tot[0], tot[1:1 + p], tot[1 + p:].reshape(p, p)
        d = A.diagonal()
        live_d = (d > d.max() * 1e-300 if d.max() > 0
                  else np.zeros_like(d, bool))
        dx = np.zeros(p)
        if live_d.any():
            As = A[np.ix_(live_d, live_d)].copy()
            As[np.diag_indices_from(As)] *= 1.0 + lam
            dx[live_d] = np.linalg.solve(As, -Jtr[live_d])
        return float(rsq), th + torch.as_tensor(dx, device=dev)

    step.jac_mode = jac_mode
    return step
