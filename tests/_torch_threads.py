"""One torch CPU thread while a port test module runs.

The suite runs several pytest workers on one CPU; torch's default of one
OpenMP thread per core in every worker oversubscribes it, and its spinning
threads slow every worker down, the JAX tests included (a subset of
tests/test_torch_inverse.py took 241 s with 8 threads and 60 s with 1
while six other processes kept the CPU busy).  Import the fixture into a
test module to apply it there.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
