"""The benchmark's tests run the port on the CPU beside other test workers:
two threads each keep them from crowding one another out."""

import pytest


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(2)
    yield
