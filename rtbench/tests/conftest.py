"""The harness's CPU runs take one intra-op thread: the suite runs many
test files at once, and other files' wall-clock tests must not starve."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
