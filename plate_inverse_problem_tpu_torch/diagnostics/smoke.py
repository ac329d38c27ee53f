"""Elementwise smoke test + device inventory report (port of the JAX
package's ``diagnostics/smoke.py``)."""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def test_function(x: np.ndarray, verbose: bool = False,
                  device="cuda") -> np.ndarray:
    """Compute ``2x + sin(x)`` on ``device`` (the card unless the caller
    asks for the CPU) as two torch ops, ``sin`` and an ``add`` with
    ``alpha=2``, in x's dtype; the analog of the reference's OpenMP smoke
    kernel (test_function.h:18-46).  Returns a numpy array.  A CUDA device
    without CUDA raises: no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    t0 = time.perf_counter()
    xt = torch.as_tensor(np.asarray(x), device=dev)
    y = torch.add(torch.sin(xt), xt, alpha=2.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if verbose:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        print(f"devices: {n_dev} ({dev.type}), "
              f"elapsed: {time.perf_counter() - t0:.4f}s, n={np.size(x)}")
    return y.cpu().numpy()


def _power_limits() -> list:
    """Each card's power limit as ``nvidia-smi`` prints it ("700.00 W"),
    in its order, or [] where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.split(",")[-1].strip() for line in out.splitlines()
            if line.strip()]


def device_report() -> dict:
    """Inventory of the visible devices (replaces the thread-count report):
    the backend ("cuda" or "cpu"), ``torch.cuda.device_count()``, and each
    device's name and power limit (None on the CPU, or where nvidia-smi
    cannot read it); ``x64`` is True (f64 is native everywhere)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count:
        limits = _power_limits()
        devices = [{"name": torch.cuda.get_device_name(i),
                    "power_limit": limits[i] if i < len(limits) else None}
                   for i in range(count)]
    else:
        devices = [{"name": "cpu", "power_limit": None}]
    return {
        "backend": "cuda" if count else "cpu",
        "n_devices": count,
        "devices": devices,
        "x64": True,
    }
