"""Test settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the `card` marker, for tests that run a cell on a
CUDA card and skip without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
