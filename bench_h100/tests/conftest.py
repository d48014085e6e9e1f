"""Shared fixtures of the benchmark's tests.  Tests that need the card
take the ``card`` fixture and carry the ``cuda`` marker: they skip on a
machine without one, decided when the test runs."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    # several workers share the machine's cores
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
