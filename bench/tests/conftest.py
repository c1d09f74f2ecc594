"""The benchmark's tests import the program from ``src`` as the benchmark
does; card-only tests carry the ``gpu`` marker and skip inside a fixture."""
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny cells on one CPU thread: beside other test processes, a
    pool of threads a process waits on makes each step many times
    slower, and a serving window of a second then finishes nothing."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
