"""Path helpers (reference: jax_plate/Utils.py:62-68)."""
from __future__ import annotations

import os


def get_package_dir() -> str:
    """Absolute path of the ``plate_inverse_problem_tpu_torch`` package
    directory."""
    return os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def get_repo_dir() -> str:
    """Directory that contains the package (analog of reference's source dir)."""
    return os.path.split(get_package_dir())[0]


def get_output_dir(kind: str = "optimization") -> str:
    """Directory for run artifacts (reports / logs).

    The reference writes into ``source/optimization`` (Problem.py:902-912);
    we write next to the package, creating the directory on demand.  Override
    with ``PIP_TPU_OUTPUT_DIR``.
    """
    base = os.environ.get("PIP_TPU_OUTPUT_DIR", os.path.join(get_repo_dir(), kind))
    os.makedirs(base, exist_ok=True)
    return base
