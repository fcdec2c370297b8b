"""Tests of the benchmark's own code. Run on the CPU from the repository
root with ``python -m pytest spbench/tests -q``; the tests marked ``card``
need a CUDA card and skip without one (the same command runs them on the
card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu():
    """The CPU, as the port's default device for the test."""
    import torch
    from spalinalg_tpu_torch import default_device

    with default_device("cpu"):
        yield torch.device("cpu")


@pytest.fixture
def card_absent():
    """Skips the test where a CUDA card is present."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
