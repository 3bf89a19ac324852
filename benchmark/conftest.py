"""pytest settings of the benchmark's own tests (benchmark/tests/):
the `card` marker, and the fixture that decides, inside a test, whether
a CUDA card is there."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip machine")
    return torch.cuda.get_device_name()
