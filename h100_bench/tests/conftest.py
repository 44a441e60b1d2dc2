"""The harness's own tests: CPU at tiny sizes, and the control on the card
(marked `gpu`, skipped without one)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
