"""Test set-up of the benchmark's own tests (CPU, small sizes).

    python -m pytest bench_h100/tests -q

The tests marked ``cuda`` need a card and skip with a reason where there
is none; on the card they run the controls at the cells' own sizes.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason where there is none"
    )


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return torch.device("cuda:0")
