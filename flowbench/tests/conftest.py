"""The benchmark's own tests: ``python -m pytest flowbench/tests -q`` from
the repository root. Tests marked ``card`` need an NVIDIA card (the
``card`` fixture decides while the test runs, and skips without one); run
them on the card with ``python -m pytest flowbench/tests -q -m card``."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def pytest_configure(config):
    import torch

    # Several workers share the CPU: one process's threads on every core
    # each would slow them all.
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
