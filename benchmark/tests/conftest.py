"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the checkout. Tests marked `card` need a CUDA card and skip without one;
whether there is one is decided inside the `card` fixture, never while a
module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs only on a CUDA card")
    return torch.device("cuda", 0)
