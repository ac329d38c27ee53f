"""Start ranks on one host and run the sharded path's checks in them.

``spawn`` starts ``world`` processes with ``torch.multiprocessing``'s
``spawn`` start method (CUDA cannot fork), joins them in a process group
through a ``file://`` store in a temporary directory and raises in the
caller if any rank raised.  ``sharded_checks`` is the rank body the CPU
tests and ``chip_smoke.py`` run: on a plate, for each mesh asked for, the
sharded FRF, training step and Gauss-Newton steps (twice each, for the
bits), with each step's wall seconds, collective seconds and kernel
launches, and what the rank's device holds before and after the mesh
places its operator data; rank r writes ``rank{r}.pt`` into the output
directory.
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.dense import blocked_matmul
from ..ops.mg import TwoGridRows
from .freq_shard import (
    _PARTITIONED, RowShard, _placed, init, make_mesh, row_range,
    shard_frequencies, sharded_fr_function, sharded_gn_step,
    sharded_train_step,
)

# right-hand sides of the GEMM that holds a dof rank's owned rows against
# the view of the whole matrix (``row_products``)
VIEW_LANES = 1024


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
    (the bench plate), ``"accel": False`` for the pure-bending path;
    ``"precond"`` and ``"operator_layout"`` are the Problem's (default
    "auto"), ``"opdata"`` a JAX operator dict of numpy arrays it runs on
    (``opdata_from_jax``)."""
    from .. import (Accelerometer, Geometry, GeometryParams, Problem,
                    get_material, opdata_from_jax)

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
    kw = {k: plate[k] for k in ("precond", "operator_layout") if k in plate}
    if "opdata" in plate:
        kw["opdata"] = opdata_from_jax(plate["opdata"], device)
    return Problem(geom, mat, acc if plate.get("accel", True) else None,
                   device=device, **kw)


def _launches():
    """K1's launches (on a window pack among them), K3's and the dof row
    blocks' products (K5)."""
    from ..ops import band_kernel, csr_kernel
    return {"k1": band_kernel.band_mv_f32_cuda.launches,
            "k1_window": band_kernel.band_mv_f32_cuda.window_launches,
            "k3": csr_kernel.csr_mv_cuda.launches, "k5": RowShard.applies}


def _timed(mesh, rec, name, fn):
    """fn() with its wall seconds (synchronised), collective seconds and
    K1 / K3 / K5 launches under ``name``."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    n0 = _launches()
    c0 = mesh.collective_s
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(mesh.device)
    rec["s"].setdefault(name, []).append(time.perf_counter() - t0)
    rec["collective_s"].setdefault(name, []).append(mesh.collective_s - c0)
    for k, n in _launches().items():
        rec[k][name] = rec[k].get(name, 0) + n - n0[k]
    return out


def _memory(device) -> dict:
    """Bytes the caching allocator has allocated and reserved on a CUDA
    ``device`` (nothing on the CPU)."""
    if device.type != "cuda":
        return {}
    return {"allocated": torch.cuda.memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device)}


def _nbytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


def _pack_bytes(pack) -> int:
    return sum(_nbytes(t) for t in (pack.vals, pack.col0, pack.row_ptr))


def held_bytes(problem) -> dict:
    """Bytes of each entry the dof axis partitions that the Problem's
    operator data holds, and of the two-grid's K1 pack (``mg_pack``): the
    whole entry, or once placed on a dof mesh this rank's share."""
    od = problem.operator_data()
    out = {}
    for k, v in od.items():
        if k not in _PARTITIONED:
            continue
        if isinstance(v, TwoGridRows):
            out |= {k: _nbytes(v.band), "mg_pack": _pack_bytes(v.pack),
                    "mg_Pt": _nbytes(v.Pt), "mg_dinv": _nbytes(v.dinv)}
        else:
            out[k] = _nbytes(v.rows if isinstance(v, RowShard) else v)
    if "mg_band0" in od and "mg_pack" not in out:
        out["mg_pack"] = _pack_bytes(problem._band_pack)
    return out


def shares(opdata) -> dict:
    """The shape of each share a placed operator dict holds (the K1
    window pack's tiles under ``mg_pack``)."""
    out = {}
    for k, v in opdata.items():
        if isinstance(v, TwoGridRows):
            out |= {k: tuple(v.band.shape), "mg_pack": tuple(
                v.pack.vals.shape), "mg_Pt": tuple(v.Pt.shape),
                "mg_dinv": tuple(v.dinv.shape)}
        elif isinstance(v, RowShard):
            out[k] = tuple(v.rows.shape)
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _host_gn(p, freqs, ref, theta, mode):
    """The single-process port's Gauss-Newton step: ``ResidualFunction``'s
    r + J and the host normal equations' update."""
    rf = p.getResidualFunction(freqs, ref, kind="log_afc", jac_mode=mode)
    r, J = (_np(a) for a in rf.value_and_jac(theta))
    return float(r @ r), theta + np.linalg.solve(J.T @ J, -(J.T @ r))


def row_products(problem, n_dof: int, i_dof: int,
                 lanes: int = VIEW_LANES) -> dict:
    """Each dense inverse's rows of dof rank ``i_dof`` times (lanes, n)
    rows from a seed, as the dense apply forms them (one GEMM an owned
    block, ``ops.dense.blocked_matmul``): by the views of the whole matrix before
    placement, by the owned copy after (on the host)."""
    out = {}
    for k, v in problem.operator_data().items():
        if k not in ("invK64", "invK32", "mg_Kcinv"):
            continue
        n = v.shape[0]
        lo, hi = row_range(n, n_dof, i_dof)
        rows = v.rows if isinstance(v, RowShard) else v[lo:hi]
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (lanes, n)), dtype=rows.dtype, device=rows.device)
        out[k] = blocked_matmul(x, rows, lo, n).cpu()
    return out


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
    ``LossFunction.value_and_grad``, ``_host_gn``; "frf": the sweep's
    alone); ``spec["control"]``
    too: once, "ctrl_pad", the adjoint ``_host_gn`` with the last
    frequency counted twice (the fault a pad lane left in would make);
    ``spec["oracle"]``: rank 0 also holds the FRF's peak against the
    refined host splu; ``spec["at_theta"]``: the FRF at theta, not the
    truth.  On a dof mesh, "view_bits" says whether the owned rows'
    product has the bits of the view's before placement (``row_products``
    at ``VIEW_LANES`` lanes).  A dof mesh places the Problem's operator
    data, and a placed Problem serves only collective calls: there
    ``spec["reference"]`` runs the counterparts once, before the mesh
    places it (the FRF at the same theta, and of the training and
    non-chunk Gauss-Newton steps; the reference FRF for the steps is then
    the unsharded sweep at the truth).  On the card each mesh's
    record holds the device memory before and after placement (and after
    ``empty_cache``), and the rank's the build's peak.  Writes
    ``rank{rank}.pt``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    p = plate_problem(spec["plate"], device)
    t0 = time.perf_counter()
    p.getFRCore()
    out = {"n_free": p.n_free, "tier": p._tier, "build_s":
           time.perf_counter() - t0, "meshes": []}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["build_peak"] = torch.cuda.max_memory_allocated(dev)
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
               "collective_s": {}, "k1": {}, "k1_window": {}, "k3": {},
               "k5": {}}
        fs = shard_frequencies(mesh, freqs)
        rec["padded"] = _np(fs.padded)
        steps = spec["steps"]
        single = spec.get("reference")
        ref_steps = single and single != "frf"   # the steps' too
        at = theta if spec.get("at_theta") else truth

        def run(name, fn, keep):
            rec.setdefault(name, []).append(keep(_timed(mesh, rec, name,
                                                        fn)))

        def pair(res):
            return tuple(map(_np, res))

        if single and shape[1] > 1 and getattr(p, "_dof_rows", None) is None:
            # the whole Problem's counterparts, before the mesh places it
            if ref is None:
                ref = _np(p.solveForward(freqs, truth))
            run("ref_frf", lambda: p.solveForward(freqs, at), _np)
            if "train" in steps and ref_steps:
                loss = p.getLossFunction(freqs, ref, "MSE_LOG_AFC")
                run("ref_train", lambda: loss.value_and_grad(theta), pair)
            for name in ("gn_adjoint", "gn_fwd"):
                if name in steps and ref_steps:
                    run("ref_" + name, lambda: _host_gn(
                        p, freqs, ref, theta, name[3:]), pair)
        if shape[1] > 1:
            single = False
            view = row_products(p, shape[1], mesh.coords["dof"])
        gc.collect()    # what earlier meshes left in reference cycles
        rec["held_whole"] = held_bytes(p)
        rec["memory"] = {"before": _memory(dev)}
        _, od = _placed(p, mesh)
        rec["memory"]["placed"] = _memory(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            rec["memory"]["released"] = _memory(dev)
        rec["shards"] = shares(od)
        rec["held"] = held_bytes(p)
        if shape[1] > 1:
            own = row_products(p, shape[1], mesh.coords["dof"])
            rec["view_bits"] = {k: torch.equal(own[k], view[k])
                                for k in view}
            del view, own
        fn = sharded_fr_function(p, mesh)
        train = sharded_train_step(p, mesh)
        chunk = spec.get("chunk", 1)
        gns = {"gn_adjoint": sharded_gn_step(p, mesh, jac_mode="adjoint"),
               "gn_fwd": sharded_gn_step(p, mesh, jac_mode="fwd"),
               "gn_chunk": sharded_gn_step(p, mesh, jac_mode="adjoint",
                                           freq_chunk=chunk),
               "gn_fwd_chunk": sharded_gn_step(p, mesh, jac_mode="fwd",
                                               freq_chunk=chunk)}
        for i in range(spec.get("repeats", 2)):
            run("frf", lambda: fn(fs, at), _np)
            if ref is None:
                ref = rec["frf"][0][:freqs.size]
            if single:
                run("ref_frf", lambda: p.solveForward(freqs, truth), _np)
            if "train" in steps:
                run("train", lambda: train(freqs, ref, theta), pair)
                if single and ref_steps:
                    loss = p.getLossFunction(freqs, ref, "MSE_LOG_AFC")
                    run("ref_train", lambda: loss.value_and_grad(theta), pair)
            for name, gn in gns.items():
                if name in steps:
                    run(name, lambda: gn(freqs, ref, theta), pair)
                    if single and ref_steps and not name.endswith("_chunk"):
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
