"""Puts the checkout's root and ``src/`` on the path, as ``bench/run.py``
does, so that ``bench`` and the program import under plain ``pytest``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests' sizes are small, and the suite's
    workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
