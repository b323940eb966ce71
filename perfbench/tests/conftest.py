"""The benchmark's tests: ``python -m pytest perfbench/tests -q`` on the CPU;
tests marked ``card`` need an NVIDIA card and skip without one (on the
card: ``python3 -m pytest perfbench/tests -q -m card --confcutdir
perfbench/tests -p no:cacheprovider``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a host without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
