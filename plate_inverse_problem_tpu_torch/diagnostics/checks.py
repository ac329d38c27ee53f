"""Numerical-health guards (port of the JAX package's
``diagnostics/checks.py``).

The reference's failure handling is status-check-and-raise (UMFPACK status
-> runtime_error, umfpack_interface.h:10-18).  PyTorch runs eagerly, so the
guards are plain ``torch.isfinite`` checks that raise
``FloatingPointError``; ``checked`` keeps the JAX signature of checkify's
wrapper, returning ``(err, out)``.
"""
from __future__ import annotations

import numpy as np
import torch


def _finite(x) -> bool:
    """True when the tensor or array ``x`` holds no NaN or Inf (on the
    card: one reduction, read back)."""
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.all(np.isfinite(np.asarray(x))))


def assert_finite(name: str = "value"):
    """Returns fn(x) -> x that raises ``FloatingPointError`` on NaN/Inf."""

    def guard(x):
        if not _finite(x):
            raise FloatingPointError(f"{name} contains NaN/Inf")
        return x

    return guard


class CheckError:
    """What ``checked`` returns beside the output (checkify's ``Error``):
    ``get()`` is the message of the guard that fired, or None, and
    ``throw()`` raises it as ``FloatingPointError``."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)


def checked(fn):
    """Wrap ``fn`` so it returns (err, out): a guard (``assert_finite``)
    that fires inside ``fn`` is caught into ``err`` (out is then None),
    and ``err.throw()`` raises it."""

    def wrapped(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except FloatingPointError as err:
            return CheckError(str(err)), None
        return CheckError(), out

    return wrapped


def _leaves(out):
    """The tensors and arrays of ``out`` (nested tuples, lists, dicts)."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out] if hasattr(out, "dtype") else []


def nan_guard(fn, label: str = "output"):
    """Eager wrapper: evaluates fn and raises FloatingPointError on non-finite
    results (the simple production guard for optimizer loops)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in _leaves(out):
            if not _finite(leaf):
                raise FloatingPointError(f"{label}: non-finite values detected")
        return out

    return wrapped
