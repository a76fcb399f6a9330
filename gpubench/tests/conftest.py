"""The benchmark's tests: on the CPU at tiny sizes, and (marked ``card``)
on a CUDA card; a card test skips without one, decided in a fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
