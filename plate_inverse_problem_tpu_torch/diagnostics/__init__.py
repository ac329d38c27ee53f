"""Device diagnostics: smoke tests, the f64 oracle audit and peak polish,
numerical guards and profiler traces (port of the JAX package's
``diagnostics``, with its exported names).

Counterpart of the reference's native-lib smoke test
(reference source/jax_plate_lib/include/test_function.h:18-46 —
``2x + sin(x)`` OpenMP-parallel with a thread-count report, exercised by
examples/test_cpp_lib.py).
"""
from .smoke import test_function, device_report
from .oracle import frf_oracle, oracle_check, polish_peaks

__all__ = ["test_function", "device_report", "frf_oracle", "oracle_check",
           "polish_peaks"]
