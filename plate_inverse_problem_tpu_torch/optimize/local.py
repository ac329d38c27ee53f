"""The optimizers' result record (JAX package ``optimize/local.py``).

The trust-region, gradient-descent and coordinate-descent optimizers of
that module are not ported yet (ROADMAP Queue 1, item D); only the record
they and Gauss-Newton share is.
"""
from __future__ import annotations

from collections import namedtuple

optResult = namedtuple(
    "optResult",
    ["x", "f", "f_history", "x_history", "grad_history", "niter", "status"],
)
