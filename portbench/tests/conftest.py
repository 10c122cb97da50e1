"""Tests of the port's benchmark (``portbench/``), on the CPU.

    python -m pytest portbench/tests -q

Tests marked ``cuda`` need a CUDA card and skip where there is none; on the
card machine ``python -m pytest portbench/tests -m cuda`` runs them.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

TINY = BENCH / "tests" / "tiny"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skips where there is none")


@pytest.fixture
def tiny_manifest():
    from manifest import Manifest

    return Manifest(TINY / "bench.json", TINY)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
