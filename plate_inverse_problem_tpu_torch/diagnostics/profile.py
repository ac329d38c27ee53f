"""Profiler capture helpers on ``torch.profiler`` (port of the JAX
package's ``diagnostics/profile.py``, SURVEY §5 tracing row).

The reference ships wall-clock prints around its solver loops
(reference examples/cpu_benchmark.py:20-36); here a capture records
the host's operators and, where the card is used, every CUDA kernel and
copy with its device time, and exports a Chrome trace (``trace.json``,
for Perfetto or chrome://tracing) into a timestamped run directory.
These wrappers standardise where captures land and pair them with the
synchronised timers of utils/timers.py.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

TRACE_FILE = "trace.json"


def default_trace_dir() -> str:
    """``$PIP_TPU_TRACE_DIR``, or ``pip_tpu_traces`` in the temporary
    directory (/tmp/pip_tpu_traces unless TMPDIR says otherwise)."""
    return os.environ.get("PIP_TPU_TRACE_DIR",
                          os.path.join(tempfile.gettempdir(),
                                       "pip_tpu_traces"))


@contextlib.contextmanager
def trace(label: str = "trace", logdir: str | None = None,
          cuda: bool | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block.

    Produces a timestamped run directory under ``logdir`` (default
    ``default_trace_dir()``) holding ``trace.json``, the Chrome trace.
    ``cuda``: record CUDA activity too (None: when a card is present).
    Yields the run directory path.
    """
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    root = logdir or default_trace_dir()
    run = os.path.join(root, f"{label}-{time.strftime('%Y%m%d-%H%M%S')}")
    os.makedirs(run, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield run
    prof.export_chrome_trace(os.path.join(run, TRACE_FILE))


def _on_card(args) -> bool:
    """True when an argument (or a tensor in a tuple, list or dict of
    them) lies on a CUDA device."""
    for a in args:
        if isinstance(a, dict):
            a = list(a.values())
        if isinstance(a, (list, tuple)) and _on_card(a):
            return True
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return True
    return False


def profile_call(fn, *args, label: str = "call", logdir: str | None = None,
                 warmup: bool = True):
    """Run ``fn(*args)`` under a profiler trace (after an optional warmup
    call, so one-time work — kernel builds, caches — stays out of the
    timeline), recording CUDA activity when an argument is on the card.
    The card is synchronised before and after the timed call, so the wall
    time is the device's.

    Returns ``(result, run_dir, wall_seconds)``.
    """
    cuda = _on_card(args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if warmup:
        fn(*args)
        sync()
    with trace(label, logdir, cuda=cuda) as run:
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        dt = time.perf_counter() - t0
    return out, run, dt
