"""The benchmark's own tests: on the CPU, and, marked `card`, on the card.

    python -m pytest benchmark/tests -q -p no:cacheprovider

A test marked `card` needs a CUDA device; it skips in its fixture where
there is none.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's tests run on the chip")
    return torch.device("cuda")
