"""One intra-op torch thread for the port's test modules. Each module pulls
the fixture in with `from tests._torch_threads import _one_thread  # noqa:
F401`; pytest takes fixtures from a test module's namespace."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's tests run many small batched ops. On a shared CPU, torch's
    intra-op threads cost more than they give: idle workers spin and take
    cores from the other test processes (one MLL gradient at G = 3, M = 64
    took 20x longer with 8 threads than with 1 on an 8-core shared x86
    host), and a fresh process's first parallel op is sometimes off
    (`scripts/check_first_parallel_op_torch.py`). Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
