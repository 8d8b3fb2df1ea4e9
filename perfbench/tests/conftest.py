"""The benchmark's own tests (run as ``python -m pytest perfbench/tests``;
the repo's ``pytest tests/`` does not collect them). Tests marked
``chip`` need a CUDA card: the ``card`` fixture skips them elsewhere."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
