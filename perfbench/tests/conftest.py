"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the checkout. Tests marked ``cuda`` need a card and skip without
one, decided inside a fixture; the rest run on the CPU at small sizes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs only on the card")
    return torch.device("cuda", 0)
