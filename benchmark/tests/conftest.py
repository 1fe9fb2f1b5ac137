"""Settings of the benchmark's own tests (CPU, small sizes)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
