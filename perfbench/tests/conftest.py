"""The checkout and its `src` on sys.path for the benchmark's CPU tests."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
