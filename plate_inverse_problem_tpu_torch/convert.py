"""Operator data from the JAX package, for holding the port against it.

``opdata_from_jax`` takes the JAX ``Problem.getFRCore()[1]`` pytree (or its
numpy form) of any engine, path and tier the port runs (mixed, modal or
direct; 3-field or symmetric; flat or band layout; dense or two-grid
preconditioner) and returns the port's tensor dict.  The modal and direct
engines read exactly the operator data every engine shares (the pattern,
``MIn``, ``fIn`` and the path's stacks, lifts and readout rows), so their
JAX opdata converts under the same keys.  Handing the JAX band basis ``W64`` to the port removes
ARPACK's random start vector from the comparison, so any difference left is
the port's.  The JAX ``trc`` entry (the material transform's constants,
such as a laminate's Q -> (A, B, D) maps, hoisted into the pytree for XLA)
is accepted and left out: the port's material holds its own.
"""
from __future__ import annotations

import numpy as np
import torch

_F64_KEYS = ("MIn", "fIn", "ABD", "fABD", "ru", "rv", "rw", "r0", "W64",
             "Kref64", "Ks", "fKs", "c", "c0")
_F32_KEYS = ("mg_band0", "mg_dinv", "mg_Pt", "mg_Kcinv", "invK32", "Kref32")
_INDEX_KEYS = ("rows", "cols", "band_lin", "mg_slots")


def opdata_from_jax(od: dict[str, np.ndarray], device) -> dict:
    """{key: tensor on ``device``} for the keys of ``od`` that the port's
    cores read: f64 operator data, f32 preconditioner data, int64 indices.
    The two-grid tier's unused (1, 1) ``invK32`` placeholder is dropped: the
    dense inverse is converted only beside its ``Kref32`` (the dense
    tier)."""
    out = {}
    for keys, dtype in ((_F64_KEYS, torch.float64),
                        (_F32_KEYS, torch.float32),
                        (_INDEX_KEYS, torch.int64)):
        for k in keys:
            if k in od and (k != "invK32" or "Kref32" in od):
                out[k] = torch.tensor(np.asarray(od[k]), dtype=dtype,
                                      device=device)
    return out
