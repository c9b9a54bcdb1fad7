"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the root of a checkout.  Those marked ``cuda`` skip without a GPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is there (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")
