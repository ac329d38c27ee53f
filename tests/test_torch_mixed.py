"""The port's mixed-precision sweep (plate_inverse_problem_tpu_torch/ops/
mixed.py) held against the JAX package's ``mixed_sweep`` on the CPU.

Both sweeps get the same numpy inputs: the JAX operator data of the small
band + two-grid plate (n = 1466, b = 256, nb = 6, n_c = 470) — sharing the
band basis W64 removes ARPACK's random start vector — and right-hand sides
assembled once in numpy.  Tolerance 3e-6 relative (the repo's band-vs-flat
tolerance, test_band.py:149-151): the f32 preconditioner rounds differently
on the two sides, which gives different FGMRES iterates.  Both sweeps are
also held to 1e-6 of a host f64 splu oracle.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import plate_inverse_problem_tpu as pip
import plate_inverse_problem_tpu_torch as pt
from plate_inverse_problem_tpu.ops import mixed as jmixed
from plate_inverse_problem_tpu_torch.ops import mg as tmg
from plate_inverse_problem_tpu_torch.ops import mixed as tmixed
from plate_inverse_problem_tpu_torch.ops.band import permute_vector
from plate_inverse_problem_tpu_torch.oracle import splu_frf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GP = (100e-3, 20e-3, 2e-3, None, None)
FREQS = np.linspace(60.0, 420.0, 8)   # includes the ~152 Hz resonance


@pytest.fixture(scope="module")
def setup():
    acc = pip.Accelerometer("AP1030")
    mat = pip.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom = pip.Geometry("sh_i", acc, pip.GeometryParams(*GP), refine=1.0)
    pj = pip.Problem(geom, mat, acc, engine="mixed", precond="mg",
                     operator_layout="band")
    od = {k: np.asarray(v) for k, v in pj.getFRCore()[1].items()
          if k != "trc"}
    acc_t = pt.Accelerometer("AP1030")
    mat_t = pt.get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    geom_t = pt.Geometry("sh_i", acc_t, pt.GeometryParams(*GP), refine=1.0)
    pp = pt.Problem(geom_t, mat_t, acc_t, device="cpu", precond="mg",
                    operator_layout="band",
                    opdata=pt.opdata_from_jax(od, "cpu"))
    pp.getFRCore()

    # right-hand sides and operator values, once, in numpy
    theta = torch.as_tensor(pp.parameters)
    (Are, Aim), (Bre, Bim), (Dre, Dim) = mat_t.abd_split(theta, 2e-3)
    Cre = torch.stack([Are, Bre, Dre]).numpy()
    Cim = torch.stack([Aim, Bim, Dim]).numpy()
    omegas = 2.0 * math.pi * FREQS
    inputs = {
        "K_re": np.einsum("mk,mkn->n", Cre, od["ABD"]),
        "K_im": np.einsum("mk,mkn->n", Cim, od["ABD"]),
        "B_re": (np.einsum("mk,mkn->n", Cre, od["fABD"])[None, :]
                 - (omegas ** 2)[:, None] * od["fIn"][None, :]),
        "B_im": np.broadcast_to(np.einsum("mk,mkn->n", Cim, od["fABD"]),
                                (FREQS.size, pp.n_free)).copy(),
        "omegas": omegas,
    }
    return pj, od, pp, inputs


def _readout(od, U_re, U_im, ts):
    def mag2(r, r0):
        return (U_re @ r + r0) ** 2 + (U_im @ r) ** 2

    return np.sqrt(ts * ts * (mag2(od["ru"], od["r0"][0])
                              + mag2(od["rv"], od["r0"][1]))
                   + mag2(od["rw"], od["r0"][2]))


def _jax_sweep(pj, od, x):
    n = pj.n_free
    mg = {"tg_band0": jnp.asarray(od["mg_band0"]),
          "dinv": jnp.asarray(od["mg_dinv"]), "Pt": jnp.asarray(od["mg_Pt"]),
          "Kc_inv": jnp.asarray(od["mg_Kcinv"]),
          "slots": jnp.asarray(od["mg_slots"]), "lmax": pj._mg_lmax,
          "rl": pj._mg_rl, "layout": pj._band_layout}
    band = {"layout": pj._band_layout, "lin": jnp.asarray(od["band_lin"]),
            "ozaki": False}

    @jax.jit
    def run(K_re, K_im, B_re, B_im, omegas):
        return jmixed.mixed_sweep(
            K_re, K_im, jnp.asarray(od["MIn"]), B_re, B_im, omegas,
            jnp.asarray(od["rows"]), jnp.asarray(od["cols"]), n,
            jnp.asarray(od["W64"]), od["invK32"], mg=mg,
            K_ref64=jnp.asarray(od["Kref64"]), ki_proportional=True,
            band=band)

    U_re, U_im = run(*(jnp.asarray(x[k]) for k in
                       ("K_re", "K_im", "B_re", "B_im", "omegas")))
    return np.asarray(U_re), np.asarray(U_im)


def _port_sweep(pp, od_t, x, **kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    return tmixed.mixed_sweep(
        t["K_re"], t["K_im"], od_t["MIn"], t["B_re"], t["B_im"], t["omegas"],
        od_t["rows"], od_t["cols"], pp.n_free, od_t["W64"],
        band={"layout": pp._band_layout, "lin": od_t["band_lin"]},
        mg={"tg_pack": pp._band_pack, "dinv": od_t["mg_dinv"],
            "Pt": od_t["mg_Pt"], "Kc_inv": od_t["mg_Kcinv"],
            "slots": od_t["mg_slots"], "lmax": pp._mg_lmax,
            "rl": pp._mg_rl, "layout": pp._band_layout},
        **({"ki_proportional": True} | kw))


@pytest.fixture(scope="module")
def sweeps(setup):
    pj, od, pp, x = setup
    Uj = _jax_sweep(pj, od, x)
    od_t = pp.getFRCore()[1]
    Ut = tuple(u.numpy() for u in _port_sweep(pp, od_t, x))
    return Uj, Ut


def test_mixed_sweep_matches_jax(setup, sweeps):
    _, od, pp, _ = setup
    (Uj_re, Uj_im), (Ut_re, Ut_im) = sweeps
    assert Ut_re.shape == (FREQS.size, pp.n_free)
    scale = np.abs(Uj_re + 1j * Uj_im).max(axis=1)
    err = np.abs((Ut_re - Uj_re) + 1j * (Ut_im - Uj_im)).max(axis=1)
    assert np.all(err <= 3e-6 * scale)
    ts = pp.accelerometer.transverse_sensitivity
    yj = _readout(od, Uj_re, Uj_im, ts)
    yt = _readout(od, Ut_re, Ut_im, ts)
    assert np.abs(yt - yj).max() / np.abs(yj).max() <= 3e-6


def test_mixed_sweep_matches_splu_oracle(setup, sweeps):
    _, od, pp, _ = setup
    (Uj_re, Uj_im), (Ut_re, Ut_im) = sweeps
    ref = splu_frf(pp, FREQS)
    ts = pp.accelerometer.transverse_sensitivity
    for U_re, U_im in ((Uj_re, Uj_im), (Ut_re, Ut_im)):
        y = _readout(od, U_re, U_im, ts)
        assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_sweep_matches_one_batch(setup, sweeps, chunk):
    """Frequency chunks (sorted by resonance amplification) and one batch
    give each lane its own iteration: the lanes agree to f64 roundoff
    amplified by the solve, far inside the 3e-6 JAX tolerance."""
    _, _, pp, x = setup
    _, (Ut_re, Ut_im) = sweeps
    Uc_re, Uc_im = (u.numpy() for u in
                    _port_sweep(pp, pp.getFRCore()[1], x, freq_chunk=chunk))
    scale = np.abs(Ut_re + 1j * Ut_im).max(axis=1)
    err = np.abs((Uc_re - Ut_re) + 1j * (Uc_im - Ut_im)).max(axis=1)
    assert np.all(err <= 1e-8 * scale)


def test_unported_sweep_options_raise(setup, sweeps):
    """The sweep once refused per-modulus loss factors; it now runs them
    with K_im as a third exact operator: on this isotropic plate, where
    K_im = beta K_re, ``ki_proportional=False`` gives the scalar-loss sweep
    to 1e-8 of a lane's max |U| (K_im u is applied, not scaled).  The
    multigrid without the band layout, which it also refused, is the flat
    multilevel preconditioner: the sweep on the flat pattern (the band
    layout's numbering, its P's rows permuted alike) with a two-level
    hierarchy meets the two-grid sweep to 3e-6 of a lane's max |U| and
    the splu oracle to 1e-6."""
    _, _, pp, x = setup
    _, (Ut_re, Ut_im) = sweeps
    od_t = pp.getFRCore()[1]
    U_re, U_im = (u.numpy() for u in
                  _port_sweep(pp, od_t, x, ki_proportional=False))
    scale = np.abs(Ut_re + 1j * Ut_im).max(axis=1)
    err = np.abs((U_re - Ut_re) + 1j * (U_im - Ut_im)).max(axis=1)
    assert np.all(err <= 1e-8 * scale)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    lay = pp._band_layout
    c_mesh, c_free, c_con = pp._coarse_level(2.0)
    P = tmg.build_prolongation(pp.mesh, c_mesh, pp.op.free_idx, c_free,
                               pp.op.constrained, c_con, three_field=True)
    arr, st = tmg.build_multilevel_host(
        od_t["Kref64"].numpy(), od_t["rows"].numpy(), od_t["cols"].numpy(),
        pp.n_free, [P[lay.perm].tocsr()],
        row_scale=permute_vector(lay, pp._eq_scale))
    U_re, U_im = (u.numpy() for u in tmixed.mixed_sweep(
        t["K_re"], t["K_im"], od_t["MIn"], t["B_re"], t["B_im"],
        t["omegas"], od_t["rows"], od_t["cols"], pp.n_free, od_t["W64"],
        mg={"multilevel": tmg.multilevel_to_device(arr, st, "cpu"),
            "Kref32": od_t["Kref64"].float()}))
    err = np.abs((U_re - Ut_re) + 1j * (U_im - Ut_im)).max(axis=1)
    assert np.all(err <= 3e-6 * scale)
    y = _readout(setup[1], U_re, U_im,
                 pp.accelerometer.transverse_sensitivity)
    ref = splu_frf(pp, FREQS)
    assert np.all(np.abs(y - ref) <= 1e-6 * np.abs(ref))
