"""One intra-op thread for the port's tests on the CPU.

The port's tests run many small ops: a recurrence launches its cell once
per time step, a captured step a few dozen ops per parameter. PyTorch's
default pool holds one OpenMP thread per core, every op wakes all of
them, and they spin between ops. A test process then keeps most of the
cores busy while it does little work, and starves the tests that run
beside it in other processes against a clock (the elastic drills'
leases and deadlines). On one thread the same tests finish sooner.

Every ``tests/test_torch_*.py`` imports the fixture below; being
autouse, it holds for each test of the importing module and gives the
process its thread count back after the module's last test.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
