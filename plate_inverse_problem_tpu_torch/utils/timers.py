"""Profiling helpers: first-call-vs-steady split timing with the device
synchronised (port of the JAX package's ``utils/timers.py``).

The reference only wall-clocks whole optimizer runs (Problem.py:833-836);
CUDA launches return before the card has run them, so these timers
synchronise the card (``torch.cuda.synchronize``) around each timed window
when the result holds CUDA tensors, and the times are the device's.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


@contextmanager
def Timer(label: str = "", results: dict | None = None):
    """Context manager measuring wall-clock seconds; stores into ``results``."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label or "elapsed"] = dt


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or a tuple,
    list or dict of them, nested)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(o) for o in out)) if out else set()
    return set()


def _block(out):
    """Wait for the card(s) that hold ``out``'s tensors; returns ``out``."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


def block_and_time(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """Run ``fn`` with device sync; return (result, first_s, per_call_s).

    The first call includes one-time work (kernel builds, CUDA start-up,
    caches); the later ones measure steady state.  The JAX function's
    second value is its compile time.
    """
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    first_s = time.perf_counter() - t0

    for _ in range(max(0, warmup - 1)):
        _block(fn(*args, **kwargs))

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _block(out)
    per_call = (time.perf_counter() - t0) / max(iters, 1)
    return out, first_s, per_call
