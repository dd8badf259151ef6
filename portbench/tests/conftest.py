"""Fixtures of the benchmark's tests: one torch thread a test process (the
eager reference is many small tensor ops, where a thread pool costs more
than it gains beside other test processes), and the card for the tests
marked `cuda`, which skip without one. Run them all from the root of the
repository:

    python -m pytest portbench/tests -q

The card's tests run on the card by the same command; without one they
skip.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
