"""Start ranks on one host and run the sharded path's checks in them.

``spawn`` starts ``world`` processes with ``torch.multiprocessing``'s
``spawn`` start method (CUDA cannot fork), joins them in a process group
through a ``file://`` store in a temporary directory and raises in the
caller if any rank raised.  ``sharded_checks`` is the rank body the CPU
tests and ``chip_smoke.py`` run: on a plate, for each mesh asked for, the
sharded FRF, training step and Gauss-Newton steps (twice each, for the
bits), with each step's wall seconds, collective seconds and kernel
launches; rank r writes ``rank{r}.pt`` into the output directory.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .freq_shard import (
    RowShard, _placed, init, make_mesh, shard_frequencies,
    sharded_fr_function, sharded_gn_step, sharded_train_step,
)


def _rank_main(rank, world, fn, args, backend, device, store):
    torch.set_num_threads(1)
    # one host: the local rank is the rank ("cuda" is cuda:LOCAL_RANK)
    os.environ["LOCAL_RANK"] = str(rank)
    dev = init(backend, device, init_method=store, rank=rank,
               world_size=world)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str | None = None,
          device="cpu") -> None:
    """Run ``fn(rank, device, *args)`` on ``world`` new processes in one
    process group (``init``'s backend choice for ``device``; "cuda" is
    each rank's card, cuda:LOCAL_RANK, or name one card for every rank).
    ``fn`` must be importable (it is pickled by name); a rank's exception
    raises here (``torch.multiprocessing.ProcessRaisedException``)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main, args=(world, fn, args, backend, device,
                                             store),
                           nprocs=world, join=True, start_method="spawn")


def plate_problem(plate: dict, device):
    """The isotropic steel plate of a spec: ``{"geometry": "symm", "ny":
    1}`` (the JAX tests' strip) or ``{"geometry": "sh_i", "refine": 1.0}``
    (the bench plate), ``"accel": False`` for the pure-bending path."""
    from .. import (Accelerometer, Geometry, GeometryParams, Problem,
                    get_material)

    acc = Accelerometer("AP1030")
    if plate["geometry"] == "symm":
        geom = Geometry("symm", acc,
                        GeometryParams(100e-3, 20e-3, 2e-3, 10e-3, None),
                        ny=plate.get("ny", 1))
    else:
        geom = Geometry("sh_i", acc,
                        GeometryParams(100e-3, 20e-3, 2e-3, None, None),
                        refine=plate.get("refine", 1.0))
    mat = get_material(7920.0, "isotropic", E=200e9, G=75e9, beta=0.003)
    return Problem(geom, mat, acc if plate.get("accel", True) else None,
                   device=device)


def _launches():
    from ..ops import band_kernel, csr_kernel
    return (band_kernel.band_mv_f32_cuda.launches,
            csr_kernel.csr_mv_cuda.launches)


def _timed(mesh, rec, name, fn):
    """fn() with its wall seconds (synchronised), collective seconds and
    K1 / K3 launches under ``name``."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    k1, k3 = _launches()
    c0 = mesh.collective_s
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(mesh.device)
    k1e, k3e = _launches()
    rec["s"].setdefault(name, []).append(time.perf_counter() - t0)
    rec["collective_s"].setdefault(name, []).append(mesh.collective_s - c0)
    rec["k1"][name] = rec["k1"].get(name, 0) + k1e - k1
    rec["k3"][name] = rec["k3"].get(name, 0) + k3e - k3
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _host_gn(p, freqs, ref, theta, mode):
    """The single-process port's Gauss-Newton step: ``ResidualFunction``'s
    r + J and the host normal equations' update."""
    rf = p.getResidualFunction(freqs, ref, kind="log_afc", jac_mode=mode)
    r, J = (_np(a) for a in rf.value_and_jac(theta))
    return float(r @ r), theta + np.linalg.solve(J.T @ J, -(J.T @ r))


def sharded_checks(rank: int, device, out_dir: str, spec: dict) -> None:
    """The rank body: on ``spec["plate"]`` (``plate_problem``), for each
    (n_freq, n_dof) of ``spec["meshes"]``, ``spec["repeats"]`` runs of the
    steps of ``spec["steps"]`` ("frf", "train", "gn_adjoint", "gn_fwd")
    at ``spec["freqs"]`` (lo, hi, count), the reference FRF the plate's at
    the truth (from the first mesh's sharded FRF) and theta = truth x
    ``spec["theta"]``; steps "gn_chunk" / "gn_fwd_chunk" are adjoint /
    fwd at ``freq_chunk=spec["chunk"]`` (default 1).
    ``spec["reference"]``: after each step its single-process counterpart
    on the same inputs, under "ref_<step>" (the sweep,
    ``LossFunction.value_and_grad``, ``_host_gn``); ``spec["control"]``
    too: once, "ctrl_pad", the adjoint ``_host_gn`` with the last
    frequency counted twice (the fault a pad lane left in would make);
    ``spec["oracle"]``: rank 0 also holds the FRF's peak against the
    refined host splu.  Writes ``rank{rank}.pt``."""
    p = plate_problem(spec["plate"], device)
    t0 = time.perf_counter()
    p.getFRCore()
    out = {"n_free": p.n_free, "tier": p._tier, "build_s":
           time.perf_counter() - t0, "meshes": []}
    freqs = np.linspace(*spec["freqs"])
    truth = np.asarray(p.parameters, np.float64)
    theta = truth * np.asarray(spec["theta"])
    ref = None
    for shape in spec["meshes"]:
        mesh = make_mesh(dof_axis=shape[1], device=device)
        mesh.timed = True
        if tuple(mesh.shape.values()) != tuple(shape):
            raise ValueError(f"mesh {mesh.shape} in a world of "
                             f"{dist.get_world_size()}, not {shape}")
        rec = {"shape": shape, "coords": mesh.coords, "s": {},
               "collective_s": {}, "k1": {}, "k3": {}}
        fs = shard_frequencies(mesh, freqs)
        rec["padded"] = _np(fs.padded)
        _, od = _placed(p, mesh)
        rec["shards"] = {k: tuple(v.rows.shape) for k, v in od.items()
                         if isinstance(v, RowShard)}
        steps = spec["steps"]
        fn = sharded_fr_function(p, mesh)
        train = sharded_train_step(p, mesh)
        chunk = spec.get("chunk", 1)
        gns = {"gn_adjoint": sharded_gn_step(p, mesh, jac_mode="adjoint"),
               "gn_fwd": sharded_gn_step(p, mesh, jac_mode="fwd"),
               "gn_chunk": sharded_gn_step(p, mesh, jac_mode="adjoint",
                                           freq_chunk=chunk),
               "gn_fwd_chunk": sharded_gn_step(p, mesh, jac_mode="fwd",
                                               freq_chunk=chunk)}
        single = spec.get("reference")

        def run(name, fn, keep):
            rec.setdefault(name, []).append(keep(_timed(mesh, rec, name,
                                                        fn)))

        def pair(res):
            return tuple(map(_np, res))

        for i in range(spec.get("repeats", 2)):
            run("frf", lambda: fn(fs, truth), _np)
            if ref is None:
                ref = rec["frf"][0][:freqs.size]
            if single:
                run("ref_frf", lambda: p.solveForward(freqs, truth), _np)
            if "train" in steps:
                run("train", lambda: train(freqs, ref, theta), pair)
                if single:
                    loss = p.getLossFunction(freqs, ref, "MSE_LOG_AFC")
                    run("ref_train", lambda: loss.value_and_grad(theta), pair)
            for name, gn in gns.items():
                if name in steps:
                    run(name, lambda: gn(freqs, ref, theta), pair)
                    if single and not name.endswith("_chunk"):
                        run("ref_" + name, lambda: _host_gn(
                            p, freqs, ref, theta, name[3:]), pair)
            if spec.get("control") and i == 0:
                run("ctrl_pad", lambda: _host_gn(
                    p, np.append(freqs, freqs[-1]),
                    np.concatenate([ref, ref[-1:]]), theta, "adjoint"), pair)
        if spec.get("oracle") and rank == 0:
            from ..oracle import splu_frf

            i = int(np.argmax(np.abs(rec["frf"][0][:freqs.size])))
            exact = splu_frf(p, freqs[[i]])[0]
            rec["peak"] = (float(freqs[i]),
                           float(abs(rec["frf"][0][i] - exact) / abs(exact)))
        rec["collectives"] = mesh.collectives
        out["meshes"].append(rec)
    out["threads"] = torch.get_num_threads()
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith("jax."))
    out["truth"], out["theta"], out["ref"] = truth, theta, ref
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def load(out_dir: str, world: int) -> list:
    """The ranks' records ``sharded_checks`` wrote, in rank order."""
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
