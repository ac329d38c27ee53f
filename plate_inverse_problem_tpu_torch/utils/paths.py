"""Path helpers (reference: jax_plate/Utils.py:62-68)."""
from __future__ import annotations

import os


def get_package_dir() -> str:
    """Absolute path of the ``plate_inverse_problem_tpu_torch`` package
    directory."""
    return os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
