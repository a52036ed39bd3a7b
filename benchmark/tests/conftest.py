"""The benchmark's own tests run on the CPU at tiny sizes; a few torch
threads keep their small operations fast on a shared host."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)
