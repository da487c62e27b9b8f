"""Fixtures shared by the port's CPU test files; a file imports the ones
it uses (``from torch_fixtures import one_torch_thread``)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for each test: they run many small CPU ops,
    which a thread pool only slows when the suite's workers share the
    cores (tens of times, measured)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
