"""Optimization report / history-log writers.

Same artifact formats as the reference (Problem.py:865-912): a human-readable
``<case><uid>.txt`` report and a ``np.savez_compressed`` archive with the full
x/f iteration history and step count.
"""
from __future__ import annotations

import os
from time import gmtime, strftime

import numpy as np

from ..utils.paths import get_output_dir


def default_uid() -> str:
    return strftime("%d_%m_%Y_%H_%M_%S", gmtime())


def write_report(full_str: str, rep_str: str, out_dir: str | None = None) -> str:
    out_dir = out_dir or get_output_dir()
    full_path = os.path.join(out_dir, full_str + ".txt")
    with open(full_path, "w+") as file:
        file.write(rep_str)
    return full_path


def write_log(full_str: str, result, out_dir: str | None = None) -> str:
    out_dir = out_dir or get_output_dir()
    f_ = np.array(list(result.f_history) + [result.f])
    x_ = np.array(list(result.x_history) + [result.x])
    k_ = np.array([result.niter])
    path = os.path.join(out_dir, full_str)
    np.savez_compressed(path, x=x_, f=f_, k=k_)
    return path + ".npz"
