"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
repository root. The harness's modules and the port are put on the path
as ``bench/run.py`` puts them."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def cuda_device():
    """The card, for the tests marked ``cuda``; they skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
