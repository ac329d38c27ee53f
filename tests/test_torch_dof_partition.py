"""The dof axis's ownership of the dense inverses' rows
(plate_inverse_problem_tpu_torch/parallel/freq_shard.py) on the CPU.

A rank of a dof group keeps only its rows of each dense inverse
(``invK64``, the JAX package's ``invK32``, ``mg_Kcinv``) and of the band
basis ``W64``: whole blocks of ``ops.dense.fixed_blocks`` (``row_range``),
copied in the full matrix's layout, the full matrix dropped.  The dense
apply multiplies by those blocks one GEMM each, whole or owned, so an
owned block's product keeps the whole apply's bits, and the placed
Problem serves only collective calls.  The plate is the parallel tests'
``symm`` ny = 1 (n = 420, flat + dense), one fresh Problem a placement;
the meshes are in-process ``Mesh`` objects without a process group, whose
all_reduce is a no-op, so a rank's product here is its column blocks
alone.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu_torch.diagnostics.oracle import polish_peaks
from plate_inverse_problem_tpu_torch.ops.dense import (
    blocked_matmul, dense_apply)
from plate_inverse_problem_tpu_torch.parallel import (
    Mesh, make_mesh, opdata_shardings, shard_frequencies, sharded_fr_function)
from plate_inverse_problem_tpu_torch.parallel import ranks
from plate_inverse_problem_tpu_torch.parallel.freq_shard import (
    RowShard, _placed, row_range)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PLATE = {"geometry": "symm", "ny": 1}
FREQS = np.linspace(40.0, 600.0, 6)


def _problem():
    p = ranks.plate_problem(PLATE, "cpu")
    p.getFRCore()
    return p


def _x(n, dtype=torch.float64, lanes=5):
    """(lanes, n) right-hand sides from a seed."""
    rng = np.random.default_rng(7)
    return torch.as_tensor(rng.standard_normal((lanes, n)), dtype=dtype)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_owns_only_its_rows(rank):
    """On a (freq 1, dof 2) mesh the Problem's operator data holds this
    rank's (hi - lo) x n block of invK64 (whole blocks of fixed_blocks)
    and its rows of W64, and nothing of the rest: the full matrices are
    unreachable once placed (the getFRCore memo, the getFRFunction memo
    and its opdata, the meshes' records, a dof-1 mesh's function made
    before, which then raises)."""
    p = _problem()
    fn = p.getFRFunction()
    od = p.getFRCore()[1]
    assert fn.opdata is od
    n = p.n_free
    m = od["W64"].shape[1]
    full = weakref.ref(od["invK64"])
    full_w = weakref.ref(od["W64"])
    world1 = make_mesh()
    fn1 = sharded_fr_function(p, world1)
    mesh = Mesh(1, 2, rank, None, {})
    _, placed = _placed(p, mesh)
    gc.collect()
    assert full() is None and full_w() is None
    with pytest.raises(ValueError, match="dof mesh"):
        fn1(shard_frequencies(world1, FREQS), p.parameters)
    lo, hi = row_range(n, 2, rank)
    assert (lo, hi) == ((0, 192), (192, 420))[rank]
    for shard in (od["invK64"], fn.opdata["invK64"], placed["invK64"]):
        assert isinstance(shard, RowShard)
        assert (shard.lo, shard.hi, shard.shape) == (lo, hi, (n, n))
        assert shard.rows.untyped_storage().nbytes() == (hi - lo) * n * 8
    assert placed["invK64"].rows is od["invK64"].rows
    assert (od["W64"].lo, od["W64"].hi, od["W64"].shape) == (lo, hi, (n, m))
    assert ranks.held_bytes(p) == {"invK64": (hi - lo) * n * 8,
                                   "W64": (hi - lo) * m * 8}
    assert opdata_shardings(mesh, od)["invK64"] == ("dof", None)
    assert opdata_shardings(mesh, od)["W64"] == ("dof", None)
    assert _placed(p, mesh)[1] is placed


@pytest.mark.parametrize("layout", ["problem", "row_major", "col_major"])
def test_owned_block_product_has_view_bits(layout):
    """The owned blocks' product is the product by the views of the full
    matrix's blocks bit for bit, and the ranks' blocks added as the dof
    group's all_reduce adds them are ``dense_apply``'s whole product bit
    for bit: the Problem's own inverse (row-major, ``inv_refined``), a
    row-major one and a column-major one (as a host splu's solve against
    the identity comes)."""
    rng = np.random.default_rng(3)
    if layout == "problem":
        p = _problem()
        full = p.getFRCore()[1]["invK64"]
        assert full.is_contiguous()
    elif layout == "row_major":
        full = torch.as_tensor(rng.standard_normal((301, 301)))
        assert full.is_contiguous()
    else:
        full = torch.as_tensor(np.asfortranarray(
            rng.standard_normal((301, 301))))
        assert full.stride() == (1, 301)
    n = full.shape[0]
    x = _x(n)
    ys = []
    for rank in range(2):
        lo, hi = row_range(n, 2, rank)
        view = blocked_matmul(x, full[lo:hi], lo, n)
        shard = RowShard.own(full, 2, rank)
        assert shard.rows.stride() == (
            (1, hi - lo) if full.stride(0) == 1 else (n, 1))
        y = shard.bind(Mesh(1, 2, rank, None, {})).apply_t(x)
        assert torch.equal(y[:, lo:hi], view)
        assert not y[:, :lo].any() and not y[:, hi:].any()
        ys.append(y)
    assert torch.equal(ys[0] + ys[1], dense_apply(full, x))


def test_unsharded_calls_raise_before_any_product():
    """Once placed, every unsharded entry point and every function made
    from the Problem before placement raises a ValueError naming the dof
    mesh, without multiplying by the block."""
    p = _problem()
    ref = np.ones(FREQS.size)
    theta = np.asarray(p.parameters, np.float64)
    fn = p.getFRFunction()
    loss = p.getLossFunction(FREQS, ref, "MSE_LOG_AFC")
    rf = p.getResidualFunction(FREQS, ref, kind="log_afc")
    _placed(p, Mesh(1, 2, 0, None, {}))
    n0 = RowShard.applies
    calls = {
        "getFRCore": p.getFRCore,
        "getFRFunction": p.getFRFunction,
        "getLossFunction": lambda: p.getLossFunction(FREQS, ref, "MSE"),
        "getResidualFunction": lambda: p.getResidualFunction(FREQS, ref),
        "solveForward": lambda: p.solveForward(FREQS),
        "solveInverse": lambda: p.solveInverse(
            theta, "MSE_LOG_AFC", "gd", ref_fr=(FREQS, ref), report=False,
            log=False),
        "diagnoseSweep": lambda: p.diagnoseSweep(FREQS),
        "polish_peaks": lambda: polish_peaks(p, FREQS, fr=ref + FREQS),
        "fn made before": lambda: fn(FREQS, theta),
        "loss made before": lambda: loss.value_and_grad(theta),
        "residual made before": lambda: rf.value_and_jac(theta),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="dof mesh"):
            call()
    assert RowShard.applies == n0


def test_another_dof_layout_raises():
    """A placed Problem serves meshes of its dof layout (a new Mesh object
    binds the same rows); another layout, a world of one included,
    raises."""
    p = _problem()
    _, od = _placed(p, Mesh(1, 2, 1, None, {}))
    _, od2 = _placed(p, Mesh(3, 2, 1, None, {}))
    assert od2["invK64"].rows is od["invK64"].rows
    for mesh in (Mesh(1, 2, 0, None, {}), Mesh(1, 4, 1, None, {}),
                 make_mesh()):
        with pytest.raises(ValueError, match="dof mesh"):
            sharded_fr_function(p, mesh)


def test_dof1_mesh_leaves_problem_untouched():
    """A (freq 2, dof 1) mesh and a world of one keep the whole inverse in
    the Problem, which still serves unsharded calls: the world of one's
    FRF has the unsharded sweep's bits."""
    p = _problem()
    od = p.getFRCore()[1]
    full = od["invK64"]
    for mesh in (Mesh(2, 1, 1, None, {}), make_mesh()):
        _, placed = _placed(p, mesh)
        assert placed["invK64"] is full and od["invK64"] is full
        assert all(s == () for s in opdata_shardings(mesh, od).values())
    assert getattr(p, "_dof_rows", None) is None
    mesh = make_mesh()
    fr = sharded_fr_function(p, mesh)(shard_frequencies(mesh, FREQS),
                                      p.parameters)
    assert torch.equal(fr, p.solveForward(FREQS))


def test_problems_sharing_one_dict_place_apart():
    """Problems built on one operator dict (``opdata=``) each own a copy of
    it: placing one on a dof mesh leaves the dict it was given, and every
    other Problem on that dict, whole and serving unsharded calls, with
    the bits they gave before."""
    base = _problem()
    od = base.getFRCore()[1]
    full = od["invK64"]

    def sharing():
        return pt.Problem(base.geometry, base.material, base.accelerometer,
                          device="cpu", opdata=od)

    p, q = sharing(), sharing()
    fr_q = q.solveForward(FREQS)
    fr_base = base.solveForward(FREQS)
    _placed(p, Mesh(1, 2, 0, None, {}))
    assert isinstance(p.operator_data()["invK64"], RowShard)
    with pytest.raises(ValueError, match="dof mesh"):
        p.solveForward(FREQS)
    assert od["invK64"] is full and q.operator_data()["invK64"] is full
    assert torch.equal(q.solveForward(FREQS), fr_q)
    assert torch.equal(base.solveForward(FREQS), fr_base)
    r = sharing()       # its memo built after p's placement
    assert r.operator_data()["invK64"] is full


def test_jax_invK32_and_coarse_inverse_are_placed():
    """The JAX package's f32 ``invK32`` (a Problem on its operator data)
    and a two-grid coarse inverse ``mg_Kcinv`` (column-major, as a host
    splu's solve against the identity comes) are row-owned too, each in
    its dtype, and applied in f32 as ``dense_apply`` applies them."""
    base = _problem()
    od = dict(base.getFRCore()[1])
    n = base.n_free
    rng = np.random.default_rng(5)
    kc = np.asfortranarray(rng.standard_normal((138, 138)))
    od["invK32"] = od.pop("invK64").to(torch.float32)
    od["mg_Kcinv"] = torch.as_tensor(kc, dtype=torch.float32)
    assert od["mg_Kcinv"].stride() == (1, 138)
    full = {k: od[k] for k in ("invK32", "mg_Kcinv")}
    p = pt.Problem(base.geometry, base.material, base.accelerometer,
                   device="cpu", opdata=od)
    mesh = Mesh(1, 2, 1, None, {})
    spec = opdata_shardings(mesh, p.getFRCore()[1])
    assert spec["invK32"] == spec["mg_Kcinv"] == ("dof", None)
    _, placed = _placed(p, mesh)
    for k, m in (("invK32", n), ("mg_Kcinv", 138)):
        shard = placed[k]
        lo, hi = row_range(m, 2, 1)
        assert hi == m and lo == (192, 64)[k == "mg_Kcinv"]
        assert shard.dtype == torch.float32 and (shard.lo, shard.hi) == (
            lo, hi)
        assert shard.rows.untyped_storage().nbytes() == (hi - lo) * m * 4
        x = _x(m)
        y = dense_apply(shard, x)
        assert y.dtype == torch.float32
        assert torch.equal(y[:, lo:hi], dense_apply(full[k], x)[:, lo:hi])
    m_w = od["W64"].shape[1]
    assert ranks.held_bytes(p) == {"invK32": (n - 192) * n * 4,
                                   "mg_Kcinv": (138 - 64) * 138 * 4,
                                   "W64": (n - 192) * m_w * 8}
