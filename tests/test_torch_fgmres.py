"""The port's FGMRES solver (``ops/mixed.py`` ``_pgmres``) and its Givens
least squares (``ops/fgmres_kernel.py``: the plain versions of the CUDA
kernels K7a ``givens_step`` and K7b ``backsub``), on the CPU.

* ``_pgmres`` against the JAX package's ``_pgmres`` (vmapped over the
  lanes) on a seeded split-complex system, n = 200, 8 lanes whose targets
  span 1e-4 to 1e-12 so that they stop at different steps: A = A_re + i
  A_im with a diagonally dominant real part, P the f64 inverse of a
  perturbed A_re; 8 steps a cycle, 3 cycles, no final correction, no
  absolute target.  In f64, x to 1e-10 of max |x| (measured 8.9e-16: the
  two sides' matrix products round differently).  With the f32 basis,
  x to 1e-6 of max |x| (measured 1.2e-7): the CGS2 dots and the basis
  run in f32 on both sides, summed in another order, so each cycle's
  subspace and its correction differ at f32 rounding (eps32 = 6e-8,
  times the few cycles that each lane runs); the f64 restarts correct
  the iterate but the f32 differences of the last cycle stay in x.
* ``givens_step_reference`` and ``backsub_reference`` after j steps
  against ``numpy.linalg.lstsq`` of the same upper Hessenberg matrix, on
  ``fgmres_kernel.synthetic_cycle``'s lanes: y to 1e-12 of max |y|
  (measured 1.3e-14 at k = 8, 1.4e-13 at k = 16) and rn2 to the
  least-squares residual^2 within 1e-12 of beta0^2 (measured 2.7e-17 /
  2.3e-16), for plain,
  a = 0, b = 0 and early-stopping lanes; the degenerate rotations (both
  zero: the identity; a = 0: c = 0, |s| = 1; b = 0: c = 1, s = 0) and the
  inactive lanes' state, left bit for bit.
* The dispatchers take the plain versions for CPU tensors and launch
  nothing; the CUDA wrappers refuse CPU tensors.

The kernels themselves are held against these plain versions, bit for
bit, on the card (tests/test_torch_kernel.py, ``chip_smoke.py`` phase 16).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plate_inverse_problem_tpu.ops import mixed as jmixed
from plate_inverse_problem_tpu_torch.ops import fgmres_kernel as fk
from plate_inverse_problem_tpu_torch.ops import mixed as tmixed

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, LANES, K_MAX, N_CYCLES = 200, 8, 8, 3
TOL_F64 = 1e-10
TOL_F32_BASIS = 1e-6
LSQ_TOL = 1e-12


@functools.lru_cache(maxsize=1)
def _system():
    rng = np.random.default_rng(18)
    A_re = (np.diag(4.0 + rng.random(N))
            + 0.3 * rng.standard_normal((N, N)) / np.sqrt(N))
    A_im = (0.05 * np.diag(rng.random(N))
            + 0.02 * rng.standard_normal((N, N)) / np.sqrt(N))
    P = np.linalg.inv(A_re + 0.1 * rng.standard_normal((N, N)) / np.sqrt(N))
    bb = rng.standard_normal((LANES, 2, N))
    x0 = 0.1 * rng.standard_normal((LANES, 2, N))
    tol = 10.0 ** np.linspace(-4, -12, LANES)
    return A_re, A_im, P, bb, x0, tol


def _port(basis_f32: bool):
    A_re, A_im, P, bb, x0, tol = (torch.as_tensor(a) for a in _system())

    def A_apply(x, _):
        return torch.stack([x[:, 0] @ A_re.T - x[:, 1] @ A_im.T,
                            x[:, 0] @ A_im.T + x[:, 1] @ A_re.T], dim=1)

    def P_apply(x, _):
        return (x.to(torch.float64) @ P.T).to(x.dtype)

    r0 = bb - A_apply(x0, None)
    return tmixed._pgmres(A_apply, P_apply, bb, x0, tol, K_MAX, N_CYCLES, r0,
                          None, 0, basis_f32).numpy()


def _jax(basis_f32: bool):
    A_re, A_im, P, bb, x0, tol = (jnp.asarray(a) for a in _system())

    def A_apply(x):
        return jnp.stack([A_re @ x[0] - A_im @ x[1],
                          A_im @ x[0] + A_re @ x[1]])

    def P_apply(x):
        return (x.astype(jnp.float64) @ P.T).astype(x.dtype)

    def one(b, x, t):
        return jmixed._pgmres(A_apply, P_apply, b, x, t, 0.0, K_MAX,
                              anchor=True, n_cycles=N_CYCLES,
                              basis_f32=basis_f32, r0=b - A_apply(x))

    return np.asarray(jax.jit(jax.vmap(one))(bb, x0, tol))


@pytest.mark.parametrize("basis_f32,tol", [(False, TOL_F64),
                                           (True, TOL_F32_BASIS)],
                         ids=["f64", "f32_basis"])
def test_pgmres_matches_jax(basis_f32, tol):
    x, x_jax = _port(basis_f32), _jax(basis_f32)
    assert np.all(np.isfinite(x))
    err = np.abs(x - x_jax).max() / np.abs(x_jax).max()
    assert err <= tol, err


def _run_cycle(k: int, seed: int = 0, L: int = 64):
    state, steps, H, beta0, j_fin = fk.synthetic_cycle(L, k, seed)
    before = []
    for j, s in enumerate(steps):
        before.append({key: v.clone() for key, v in state.items()})
        fk.givens_step_reference(s["hre"], s["him"], s["hlast"],
                                 *(state[key] for key in fk.STATE_KEYS),
                                 s["active"], j, j == 0)
    y = fk.backsub_reference(state["R"], state["g"], torch.as_tensor(j_fin))
    return state, before, H, beta0, j_fin, y


@pytest.mark.parametrize("k", [8, 16])
def test_givens_backsub_match_lstsq(k):
    state, _, H, beta0, j_fin, y = _run_cycle(k)
    kinds = np.arange(H.shape[0]) % 8
    yc = y[..., 0].numpy() + 1j * y[..., 1].numpy()
    rn2 = state["rn2"].numpy()
    checked = set()
    for lane in np.flatnonzero(np.isin(kinds, (0, 1, 3, 5, 6, 7))):
        jf = int(j_fin[lane])
        e = np.zeros(jf + 1, complex)
        e[0] = beta0[lane]
        y_ls = (np.linalg.lstsq(H[lane, :jf + 1, :jf], e, rcond=None)[0]
                if jf else np.zeros(0))
        res2 = np.linalg.norm(e - H[lane, :jf + 1, :jf] @ y_ls) ** 2
        scale = max(np.abs(y_ls).max(initial=0.0), 1e-300)
        assert np.abs(yc[lane, :jf] - y_ls).max(initial=0.0) <= LSQ_TOL * scale
        assert np.all(yc[lane, jf:] == 0)
        assert abs(rn2[lane] - res2) <= LSQ_TOL * beta0[lane] ** 2
        checked.add(fk.SYNTHETIC_KINDS[kinds[lane]])
    assert checked == {"a=0", "b=0", "inactive", "plain"}


def test_degenerate_and_inactive_lanes():
    k = 8
    state, before, H, beta0, j_fin, y = _run_cycle(k, seed=1)
    kinds = np.arange(H.shape[0]) % 8
    cs, sn = state["cs"].numpy(), state["sn"].numpy()
    both, a0, b0 = kinds == 2, kinds == 0, kinds == 1
    assert np.all(cs[both] == 1) and np.all(sn[both] == 0)
    assert np.all(state["rn2"].numpy()[both] == 0)
    assert np.all(cs[a0] == 0)
    assert np.allclose(np.hypot(sn[a0, :, 0], sn[a0, :, 1]), 1.0,
                       rtol=0, atol=1e-15)
    assert np.all(cs[b0] == 1) and np.all(sn[b0] == 0)
    # an inactive lane's state is left bit for bit from its last step on
    for lane in np.flatnonzero(kinds == 3):
        jf = int(j_fin[lane])
        for key, v in state.items():
            assert torch.equal(v[lane], before[jf][key][lane]), (lane, key)
    # entries near 1e-295: their squares underflow, the clamps hold
    assert torch.isfinite(y).all()
    for v in state.values():
        assert torch.isfinite(v).all()


def test_dispatch_takes_plain_version_on_cpu():
    fk.reset_launches()
    s0, steps, _, _, j_fin = fk.synthetic_cycle(16, 8, seed=2)
    s1 = {key: v.clone() for key, v in s0.items()}
    keys = fk.STATE_KEYS
    for j, s in enumerate(steps):
        args = (s["hre"], s["him"], s["hlast"])
        fk.givens_step(*args, *(s0[key] for key in keys), s["active"], j,
                       j == 0)
        fk.givens_step_reference(*args, *(s1[key] for key in keys),
                                 s["active"], j, j == 0)
    for key in keys:
        assert torch.equal(s0[key], s1[key]), key
    jf = torch.as_tensor(j_fin)
    assert torch.equal(fk.backsub(s0["R"], s0["g"], jf),
                       fk.backsub_reference(s1["R"], s1["g"], jf))
    assert fk.givens_step_cuda.launches == fk.backsub_cuda.launches == 0
    assert fk.givens_step_reference.cuda_calls == 0
    assert fk.backsub_reference.cuda_calls == 0
    with pytest.raises(ValueError):
        fk.backsub_cuda(s0["R"], s0["g"], jf)
    with pytest.raises(ValueError):
        fk.givens_step_cuda(steps[0]["hre"], steps[0]["him"],
                            steps[0]["hlast"], *(s0[key] for key in keys),
                            steps[0]["active"], 0, True)


def test_cuda_launch_state_on_cpu():
    """What the kernels' launch path keeps a cycle, on CPU tensors: the
    ``fgmres_state`` struct the launcher reads (eight pointers in
    ``STATE_KEYS``' order, then L and k), the cycle held by identity (a
    clone of one state tensor is another cycle, and a freed one ends it)
    and the per-step check."""
    import ctypes

    assert ctypes.sizeof(fk._State) == 8 * 8 + 2 * 4
    assert (fk._State.L.offset, fk._State.k.offset) == (64, 68)
    s0, steps, _, _, _ = fk.synthetic_cycle(16, 8, seed=3)
    state = tuple(s0[key] for key in fk.STATE_KEYS)
    c = fk._Cycle(state)
    assert (c.L, c.k, c.index) == (16, 8, None)
    assert [getattr(c.state, key) for key in fk.STATE_KEYS] == [
        t.data_ptr() for t in state]
    assert c.holds(state)
    assert not c.holds(tuple(t.clone() if key == "R" else t
                             for key, t in zip(fk.STATE_KEYS, state)))
    fk._cycle = c                  # forgotten once a state tensor is freed
    del s0, state
    assert fk._cycle is None
    hre, active = steps[0]["hre"], steps[0]["active"]
    assert fk._fits(hre, (16, 9), torch.float64, -1)
    assert not fk._fits(hre, (16, 8), torch.float64, -1)
    assert not fk._fits(hre.t(), (9, 16), torch.float64, -1)
    assert fk._fits(active, (16,), torch.bool, -1)
    assert not fk._fits(active, (16,), torch.float64, -1)
