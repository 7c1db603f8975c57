"""pytest settings of the benchmark's tests: the ``card`` marker, and a
fixture that skips a card test where no CUDA card is found."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on the CPU with one intra-op thread, as the suite runs on
    several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
