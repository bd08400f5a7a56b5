"""Tests of the benchmark itself.  Run from the checkout's root:

    python -m pytest bench_h100/tests -q

On a machine with no CUDA device the tests marked `h100` skip, each
deciding inside the test, through the `card` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "h100: needs an NVIDIA H100; skips where there is no "
        "CUDA device")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs only on the card")
    return torch.device("cuda")
