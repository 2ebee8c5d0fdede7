"""Settings of the benchmark's own tests (``python -m pytest
stackbench/tests -q``): the ``cuda`` marker, and few CPU threads."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
    torch.set_num_threads(2)
