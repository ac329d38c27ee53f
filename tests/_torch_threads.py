"""One torch thread and one BLAS thread while a port test module runs.

The suite runs several pytest workers on one CPU; torch's default of one
OpenMP thread per core in every worker oversubscribes it, and its spinning
threads slow every worker down, the JAX tests included (a subset of
tests/test_torch_inverse.py took 241 s with 8 threads and 60 s with 1
while six other processes kept the CPU busy).  OpenBLAS does the same:
the JAX package's CPU LAPACK calls (its direct engine's LU, its eigh)
run on scipy's OpenBLAS, one thread per core, and spin against the other
workers (a JAX direct-engine FRF and gradient on the ``symm`` ny = 1
plate took 80.5 s with 8 threads and 3.8 s with 1 beside seven busy
processes).  Import the fixture into a test module to apply it there.
"""
import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)
