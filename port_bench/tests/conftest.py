"""The benchmark's own tests: CPU tests at small sizes, and tests marked ``cuda``
that skip without a card. Run from the checkout's root:
``python -m pytest port_bench/tests -q``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
