"""Test settings of the benchmark's own tests (``pytest benchmark/tests``).

``card`` marks a test that needs an NVIDIA card; whether one is present is
decided inside the ``card`` fixture, never while a module is imported, and
a test without one skips with the reason.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
