"""The benchmark's own tests: ``python -m pytest qpbench/tests -q`` from the
root of the checkout.  They run on the CPU at tiny sizes; the one marked
``cuda`` runs a cell at a small size on the card when there is one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def tiny():
    """Sizes a CPU test can hold: n = 24 (eight 3-blocks on the cone), 8
    lanes a call."""
    return {"n": 24, "lanes": 8}
