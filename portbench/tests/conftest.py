"""The benchmark's own tests (CPU; those marked `card` need a CUDA card
and skip without one). Run from the repository root:
`python -m pytest portbench/tests -q`."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test "
        "without one")
