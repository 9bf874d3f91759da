"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`). The
harness's modules and the program are imported from the checkout; tests
marked `cuda` need the card and skip here."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return "cuda"
