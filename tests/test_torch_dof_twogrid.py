"""The dof axis's partition of the two-grid and the band basis
(plate_inverse_problem_tpu_torch/parallel/freq_shard.py, ops/mg.py
``TwoGridRows``, ops/band.py, ops/band_kernel.py window packs) on the CPU.

A rank of a dof group holds block rows [q0, q1) of the two-grid's band
``mg_band0`` with their K1 window pack, of its prolongation ``mg_Pt`` and
of its diagonal ``mg_dinv``, and rows of ``W64``; every partitioned
product has the whole one's bits.  A dof axis wider than the band's
block-row groups keeps the two-grid whole on every rank.  The plate is tests/test_torch_mg.py's
(sh_i refine 1, n = 1466, b = 256, nb = 6, n_c = 470, ``precond="mg"``,
``operator_layout="band"``) on the JAX package's operator data through
``opdata_from_jax``.  In-process ranks run in threads, their combines
through a barrier (``_Group``: each rank's part in its slot, the stack
read by all, as ``Mesh.gather`` does); one spawn of two gloo ranks runs
the sharded sweep.

Tolerances: the partitioned products against the whole ones bit for bit;
the cycle against the JAX package's ``twogrid_apply`` 1e-5 relative
(tests/test_torch_mg.py's); the gloo FRF against the single-process port
bit for bit, against the JAX package's FRF 3e-6 relative
(tests/test_torch_mixed.py's).
"""
import copy
import gc
import threading
import weakref

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import plate_inverse_problem_tpu as pip
from plate_inverse_problem_tpu.ops import mg as jmg
from plate_inverse_problem_tpu_torch.ops import mg as tmg
from plate_inverse_problem_tpu_torch.ops.band import rect_band_tmv
from plate_inverse_problem_tpu_torch.ops.band_kernel import (
    band_mv_f32_reference, pack_band_tiles)
from plate_inverse_problem_tpu_torch.ops.dense import (
    dense_apply, fixed_blocks)
from plate_inverse_problem_tpu_torch.parallel import (
    Mesh, opdata_shardings, sharded_fr_function)
from plate_inverse_problem_tpu_torch.parallel import ranks
from plate_inverse_problem_tpu_torch.parallel.freq_shard import (
    RowShard, _own_twogrid, _placed, band_range, row_range)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)
PLATE = {"geometry": "sh_i", "refine": 1.0, "precond": "mg",
         "operator_layout": "band"}
FREQS = np.linspace(60.0, 420.0, 8)   # includes the ~152 Hz resonance
THETA = (1.02, 0.99, 1.05)
KEYS = ("mg_band0", "mg_pack", "mg_Pt", "mg_dinv", "mg_Kcinv", "W64")


@pytest.fixture(scope="module")
def pair():
    """(JAX Problem, its numpy opdata, port Problem on that opdata)."""
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pip.Geometry("sh_i", acc, pip.GeometryParams(*GP), refine=1.0)
    pj = pip.Problem(geom, mat, acc, engine="mixed", precond="mg",
                     operator_layout="band")
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    return pj, od, _port(od)


def _port(od):
    p = ranks.plate_problem({**PLATE, "opdata": od}, "cpu")
    p.getFRCore()
    return p


class _Group:
    """In-process dof group of ``d`` threads: ``stack(i)`` is rank i's
    gather, every rank's part in its slot (``Mesh.gather``'s result), and
    ``mesh(i)`` an object whose ``reduce`` adds the slots in rank order
    (an all_reduce for ``RowShard``)."""

    def __init__(self, d):
        self.d, self.slots = d, [None] * d
        self.barrier = threading.Barrier(d)

    def stack(self, i):
        def gather(part):
            self.slots[i] = part.clone()
            self.barrier.wait()
            out = torch.stack(self.slots)
            self.barrier.wait()
            return out
        return gather

    def mesh(self, i):
        group = self

        class _Reduce:
            def reduce(self, buf, axis):
                st = group.stack(i)(buf)
                tot = st[0].clone()
                for part in st[1:]:
                    tot += part
                buf.copy_(tot)
        return _Reduce()

    def run(self, body):
        out = [None] * self.d

        def main(i):
            out[i] = body(i)
        threads = [threading.Thread(target=main, args=(i,))
                   for i in range(self.d)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out


def _parts(pp, d):
    """Each rank's bound ``TwoGridRows`` and coarse-inverse ``RowShard``
    of a dof group of d threads, and the group."""
    od = pp.getFRCore()[1]
    g = _Group(d)
    parts = [_own_twogrid(od, pp._band_pack, pp._band_layout, d, i)[
        "mg_band0"].bind(
        g.stack(i)) for i in range(d)]
    kc = [RowShard.own(od["mg_Kcinv"], d, i).bind(g.mesh(i))
          for i in range(d)]
    return parts, kc, g


def _r(pp, shape=(3, 2), seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(
        shape + (pp.n_free,)).astype(np.float32))


@pytest.mark.parametrize("d", [2, 3])
def test_window_packs_reassemble_the_whole_apply(pair, d):
    """Each rank's window pack, built from its block rows only, and the
    plain K1 on its x window give its rows of the whole apply bit for bit;
    the packs' tiles are the whole pack's."""
    pp = pair[2]
    lay, whole = pp._band_layout, pp._band_pack
    band = pp.getFRCore()[1]["mg_band0"]
    x = _r(pp, (5,))
    y = band_mv_f32_reference(whole, x, lay)
    tiles = 0
    for i in range(d):
        q0, q1 = band_range(lay.nb, d, i)
        pk = pack_band_tiles(band[q0:q1], lay, q0=q0)
        (lo, hi), (xlo, xhi) = pk.rows, pk.cols
        assert (lo, hi) == (q0 * lay.b, min(lay.n, q1 * lay.b))
        assert (xlo, xhi) == (max(0, lo - lay.b),
                              min(lay.n, q1 * lay.b + lay.b))
        yw = band_mv_f32_reference(pk, x[:, xlo:xhi].contiguous(), lay)
        assert torch.equal(yw, y[:, lo:hi])
        tiles += pk.vals.shape[0]
    assert tiles == whole.vals.shape[0]


@pytest.mark.parametrize("d", [2, 3])
def test_partitioned_restriction_is_rect_band_tmv(pair, d):
    """Each rank's restriction (its window terms, the neighbours' terms
    next to its bounds by one exchange, the fold in the whole d order, the
    gather of the folded blocks) is ``rect_band_tmv`` bit for bit."""
    pp = pair[2]
    od, rl = pp.getFRCore()[1], pp._mg_rl
    res = _r(pp, (4,), seed=2)
    want = rect_band_tmv(od["mg_Pt"], res, rl, od["mg_slots"])
    parts, _, g = _parts(pp, d)
    got = g.run(lambda i: parts[i].restrict(parts[i].own(res), rl,
                                            od["mg_slots"]))
    assert all(torch.equal(y, want) for y in got)


@pytest.mark.parametrize("d", [2, 3])
def test_partitioned_twogrid_has_whole_bits(pair, d):
    """The two-grid cycle on each rank's block rows, reassembled by its
    final gather, is the whole cycle bit for bit on every rank, and within
    tests/test_torch_mg.py's 1e-5 of the JAX package's cycle."""
    pj, od_np, pp = pair
    od, lay, rl = pp.getFRCore()[1], pp._band_layout, pp._mg_rl
    r = _r(pp)
    whole = tmg.twogrid_apply(pp._band_pack, od["mg_dinv"], pp._mg_lmax,
                              od["mg_Pt"], od["mg_Kcinv"], r, lay, rl,
                              od["mg_slots"])
    parts, kc, g = _parts(pp, d)
    got = g.run(lambda i: tmg.twogrid_apply_rows(
        parts[i], pp._mg_lmax, kc[i], parts[i].own(r), lay, rl,
        od["mg_slots"]))
    assert all(torch.equal(y, whole) for y in got)
    y_j = np.asarray(jmg.twogrid_apply(
        jnp.asarray(od_np["mg_band0"]), jnp.asarray(od_np["mg_dinv"]),
        pj._mg_lmax, jnp.asarray(od_np["mg_Pt"]),
        jnp.asarray(od_np["mg_Kcinv"]), jnp.asarray(r.numpy()),
        pj._band_layout, pj._mg_rl, jnp.asarray(od_np["mg_slots"])))
    assert np.abs(whole.numpy() - y_j).max() / np.abs(y_j).max() <= 1e-5


@pytest.mark.parametrize("d", [1, 2, 4])
def test_dense_apply_is_the_owned_blocks_product(pair, d):
    """``dense_apply`` by fixed row blocks is, bit for bit, the sum of the
    dof ranks' owned blocks' products (each rank's GEMMs on its copy of
    whole blocks), for the coarse inverse and the f64 dense inverse of
    another size."""
    pp = pair[2]
    rng = np.random.default_rng(4)
    kc = pp.getFRCore()[1]["mg_Kcinv"]
    inv64 = torch.as_tensor(rng.standard_normal((1466, 1466)))
    for full in (kc, inv64):
        n = full.shape[0]
        x = torch.as_tensor(rng.standard_normal((6, n)))
        g = _Group(d)
        ys = g.run(lambda i: RowShard.own(full, d, i).bind(g.mesh(i))
                   .apply_t(x.to(full.dtype)))
        want = dense_apply(full, x)
        assert all(torch.equal(y, want) for y in ys)
        bounds = [row_range(n, d, i)[0] for i in range(d)] + [n]
        assert set(bounds) <= set(fixed_blocks(n))


def test_placement_keeps_no_whole_buffer(pair):
    """Placing a fresh Problem as rank 1 of (freq 1, dof 2) leaves no
    reference to the whole ``mg_band0``, K1 pack, ``mg_Pt``, ``mg_dinv``
    or ``W64``; its operator data holds its block rows (whole groups of
    ``fixed_blocks(nb, 1)``), P's and the diagonal's in its
    ``TwoGridRows``, and the port's specs are the JAX package's on
    a (4, 2) mesh; on a dof axis with more ranks than the band has groups
    (d = 8, which divides none of the two-grid's axes) the two-grid's
    specs are the JAX package's, whole, and ``band_range`` raises for
    rows it cannot give."""
    p = _port(pair[1])
    od = p.getFRCore()[1]
    nb, b = od["mg_band0"].shape[:2]
    n, m = p.n_free, od["W64"].shape[1]
    whole = {k: weakref.ref(od[k])
             for k in ("mg_band0", "mg_Pt", "mg_dinv", "W64")}
    whole["mg_pack"] = weakref.ref(p._band_pack)
    mesh = Mesh(1, 2, 1, None, {})
    _, placed = _placed(p, mesh)
    gc.collect()
    assert all(ref() is None for ref in whole.values()), \
        [k for k, ref in whole.items() if ref() is not None]
    q0, q1 = band_range(nb, 2, 1)
    assert (q0, q1) == (3, 6) and p._band_pack is None
    part = od["mg_band0"]
    assert isinstance(part, tmg.TwoGridRows)
    assert part.bounds == (0, 3, 6) and part.rows == (q0 * b, n)
    assert "mg_Pt" not in od and "mg_dinv" not in od
    assert part.Pt.shape[0] == q1 - q0 and part.dinv.shape[0] == n - q0 * b
    lo, hi = row_range(n, 2, 1)
    bc = part.Pt.shape[2]
    held = ranks.held_bytes(p)
    assert held == {"mg_band0": (q1 - q0) * b * 3 * b * 4,
                    "mg_pack": held["mg_pack"],
                    "mg_Pt": (q1 - q0) * b * bc * 4,
                    "mg_dinv": (n - q0 * b) * 4,
                    "mg_Kcinv": held["mg_Kcinv"],
                    "W64": (hi - lo) * m * 8}
    nc = od["mg_Kcinv"].shape[0]
    kl, kh = row_range(nc, 2, 1)
    assert held["mg_Kcinv"] == (kh - kl) * nc * 4
    assert placed["mg_band0"].stack is not None and part.stack is None
    with pytest.raises(ValueError, match="dof mesh"):
        part.halo(torch.zeros(1, part.rows[1] - part.rows[0]))
    # the specs: the JAX package's on a (4, 2) mesh of 8 virtual devices
    from plate_inverse_problem_tpu.parallel import make_mesh as jmake_mesh
    from plate_inverse_problem_tpu.parallel.freq_shard import (
        opdata_shardings as jshardings)

    jod = pair[1]
    jspec = jshardings(jmake_mesh(8, dof_axis=2), jod)
    spec = opdata_shardings(Mesh(4, 2, 0, None, {}), jod)
    assert spec == {k: tuple(s.spec) for k, s in jspec.items()}
    for k in ("mg_band0", "mg_Pt", "mg_dinv", "mg_Kcinv", "W64"):
        assert spec[k] != (), k
    jspec8 = jshardings(jmake_mesh(8, dof_axis=8), jod)
    spec8 = opdata_shardings(Mesh(1, 8, 0, None, {}), jod)
    for k in ("mg_band0", "mg_Pt", "mg_dinv"):
        assert spec8[k] == tuple(jspec8[k].spec) == (), k
    with pytest.raises(ValueError, match="groups"):
        band_range(nb, 8, 0)


class _ThreadMesh(Mesh):
    """Rank i of an in-process (freq 1, dof d) mesh of threads: the dof
    axis's all_reduce is the ``_Group``'s slot sum, the freq axis has one
    rank."""

    def __init__(self, group, i):
        super().__init__(1, group.d, i, None, {})
        self._dof = group.mesh(i)

    def reduce(self, buf, axis):
        if axis == "dof":
            self._dof.reduce(buf, axis)
        self.collectives += 1


def test_dof_axis_wider_than_the_band_sweeps_whole_twogrid(pair):
    """A dof axis of 7 in-process ranks on the 6-block-row band (6 groups;
    8 fixed blocks of ``mg_Kcinv`` and ``W64``, one rank owning two): each
    rank's copy of the unplaced Problem keeps the two-grid's band, P,
    diagonal and K1 pack whole and owns its rows of ``mg_Kcinv`` and
    ``W64``; every rank's sharded FRF at the resonance's neighbour is the
    unsharded port's bits.  (The Gauss-Newton step is not run here: its
    tangents use forward-mode AD, whose levels are global to the process,
    so threads cannot run it side by side.)"""
    pp = pair[2]
    freqs = FREQS[2:3]
    theta = np.asarray(pp.parameters, np.float64) * np.asarray(THETA)
    want = pp.solveForward(freqs, theta).numpy()
    d = 7
    g = _Group(d)
    ps = [copy.deepcopy(pp) for _ in range(d)]

    def rank(i):
        p = ps[i]
        fr = sharded_fr_function(p, _ThreadMesh(g, i))(freqs, theta)
        od = p.operator_data()
        return (fr.numpy(), isinstance(od["mg_band0"], torch.Tensor)
                and isinstance(od["mg_Pt"], torch.Tensor)
                and isinstance(od["mg_dinv"], torch.Tensor)
                and p._band_pack is not None,
                {k: (od[k].lo, od[k].hi) for k in ("mg_Kcinv", "W64")})

    out = g.run(rank)
    for i, (fr, whole, rows) in enumerate(out):
        assert np.array_equal(fr, want), i
        assert whole, i
        for k, (lo, hi) in rows.items():
            n = pp.getFRCore()[1][k].shape[0]
            assert (lo, hi) == row_range(n, d, i), k


@pytest.fixture(scope="module")
def gloo(pair, tmp_path_factory):
    """Two gloo ranks as (freq 1, dof 2) on the plate at truth x THETA:
    the ranks' records (the whole Problem's FRF before placement among
    them)."""
    out = str(tmp_path_factory.mktemp("dof2"))
    spec = {"plate": {**PLATE, "opdata": pair[1]}, "meshes": [(1, 2)],
            "freqs": (FREQS[0], FREQS[-1], FREQS.size), "theta": THETA,
            "repeats": 1, "steps": (), "at_theta": True, "reference": True}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENBLAS_NUM_THREADS", "1")
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks.spawn(ranks.sharded_checks, 2, out, spec, device="cpu")
    return ranks.load(out, 2)


def test_gloo_dof2_sweep_has_the_single_process_bits(pair, gloo):
    """Each rank holds its share of every partitioned entry (half of the
    whole's bytes, to its blocks' rounding); both ranks' FRF is the
    single-process port's bit for bit, and within 3e-6 of the JAX
    package's FRF at three frequencies; the ranks ran K1 on their windows
    (the CPU's plain version: no launch to count) and the coarse
    inverse's row blocks."""
    pj, od, pp = pair
    truth = np.asarray(pp.parameters, np.float64)
    theta = truth * np.asarray(THETA)
    fr = pp.solveForward(FREQS, theta).numpy()
    whole = ranks.held_bytes(pp)
    assert set(whole) == set(KEYS)
    ms = [r["meshes"][0] for r in gloo]
    for rank, m in enumerate(ms):
        assert set(m["held"]) == set(KEYS)
        for k in KEYS:
            assert 0.25 * whole[k] < m["held"][k] < 0.75 * whole[k], k
        assert m["shards"]["mg_band0"][0] == 3
        assert m["k5"]["frf"] > 0 and m["collectives"] > 0
        assert np.array_equal(m["frf"][0][:FREQS.size], fr)
        assert np.array_equal(m["ref_frf"][0], fr)
    assert sum(m["shards"]["mg_pack"][0] for m in ms) == \
        pp._band_pack.vals.shape[0]
    idx = [1, 2, 5]
    fr_j = np.asarray(pj.getFRFunction()(FREQS[idx], theta))
    assert np.max(np.abs(fr[idx] - fr_j) / np.abs(fr_j)) <= 3e-6
