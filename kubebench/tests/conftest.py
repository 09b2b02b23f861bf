"""Tests of the benchmark. Those marked ``card`` need an NVIDIA card and
skip without one; the decision is made inside the ``cuda`` fixture, never
at import, so every worker collects the same tests."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (CUDA); skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip (kubebench/README.md)")
    return torch.device("cuda", 0)
