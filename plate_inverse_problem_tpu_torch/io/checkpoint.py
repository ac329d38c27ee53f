"""Optimizer-state checkpoint / resume.

The reference persists optimization *histories* (npz archives + text reports,
Problem.py:865-912) but cannot resume a run mid-flight (SURVEY §5).  This
module adds restartable checkpoints for long trust-region / GD runs: the full
optimizer state (current x, step sizes, radii, histories) round-trips through
a portable npz + json sidecar (no orbax dependency — the state is a flat
dict of host arrays/scalars, which npz serializes losslessly).

Host copy of the JAX package's ``io/checkpoint.py``: the same files, so a
checkpoint written by either package loads in the other; the optimizer
starts from a torch tensor (the port's optimizers return host arrays).
"""
from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(path: str, state: dict) -> str:
    """Persist an optimizer-state dict (arrays + scalars + lists of arrays)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    meta = {}
    for k, v in state.items():
        if isinstance(v, (list, tuple)) and len(v) and hasattr(v[0], "shape"):
            arrays[f"{k}__stack"] = np.stack([np.asarray(x) for x in v])
        elif hasattr(v, "shape") or isinstance(v, (int, float, np.number)):
            arrays[k] = np.asarray(v)
        else:
            meta[k] = v
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path if path.endswith(".npz") else path + ".npz"


def load_checkpoint(path: str) -> dict:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as dat:
        state = {}
        meta = json.loads(str(dat["__meta__"]))
        state.update(meta)
        for k in dat.files:
            if k == "__meta__":
                continue
            if k.endswith("__stack"):
                state[k[: -len("__stack")]] = list(dat[k])
            else:
                v = dat[k]
                state[k] = v.item() if v.ndim == 0 else v
    return state


def checkpointed_optimize(optimizer_func, f, x_0, *, checkpoint_path: str,
                          checkpoint_every: int = 5, resume: bool = True,
                          **opt_kwargs):
    """Run a (restartable-by-chunking) optimizer with periodic checkpoints.

    Splits ``N_steps`` into chunks of ``checkpoint_every`` iterations; after
    each chunk the state (x + histories) is written to ``checkpoint_path``.
    If ``resume`` and the checkpoint exists, continues from it.  Returns the
    same optResult record as the underlying optimizer, with concatenated
    histories.
    """
    import torch

    from ..optimize import optResult

    n_total = opt_kwargs.pop("N_steps", 10)
    x = np.asarray(x_0, dtype=np.float64)
    f_history: list = []
    x_history: list = []
    grad_history: list = []
    done = 0

    ck = checkpoint_path if checkpoint_path.endswith(".npz") else checkpoint_path + ".npz"
    if resume and os.path.exists(ck):
        st = load_checkpoint(ck)
        x = np.asarray(st["x"])
        done = int(st["done"])
        f_history = [float(v) for v in st.get("f_history", [])]
        x_history = list(st.get("x_history", []))
        grad_history = list(st.get("grad_history", []))

    res = None

    while done < n_total:
        chunk = min(checkpoint_every, n_total - done)
        res = optimizer_func(f, torch.as_tensor(x), N_steps=chunk,
                             **opt_kwargs)
        x = np.asarray(res.x)
        f_history += [float(v) for v in res.f_history]
        x_history += [np.asarray(v) for v in res.x_history]
        grad_history += [np.asarray(v) for v in res.grad_history]
        done += chunk
        save_checkpoint(checkpoint_path, {
            "x": x, "done": done,
            "f_history": np.asarray(f_history),
            "x_history": x_history, "grad_history": grad_history,
            "status": str(res.status),
        })
        if res.status in ("Converged",):
            break

    status = res.status if res is not None else "Resumed-complete"
    f_last = f_history[-1] if f_history else None
    return optResult(x, f_last, f_history, x_history, grad_history, done, status)
