"""Tests of the benchmark harness. They run on the CPU at tiny sizes; a
test that needs the card carries the ``card`` marker and asks the
``card`` fixture, which skips where no CUDA device is visible.

    PYTHONPATH=src python -m pytest -q bench/tests      # from the root
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible: this test runs on the card")
    return torch.device("cuda:0")
