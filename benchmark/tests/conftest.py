"""Tests of the benchmark's harness, its yardstick and its plain reference.

    python -m pytest benchmark/tests -q

They run on the CPU at tiny sizes; a test marked ``card`` needs a CUDA
card and skips without one (its fixture decides, when the test runs).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


# a cell shrunk to what the CPU renders in seconds: every layer of the
# frame runs, at 64x96 pixels, 16 depth samples and a smaller sphere
TINY = {"render": {"H": 64, "W": 96, "focal": 80.0, "K": 16},
        "scene": {"radius": 0.25}}


@pytest.fixture
def tiny():
    return TINY
