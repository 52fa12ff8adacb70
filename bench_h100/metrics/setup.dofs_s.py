"""Self seconds of the port's DoF set-up spans, every level: DoF numbering,
hanging-node constraints and operator diagonals (``mgtpu.setup.dofs``,
``mgtpu.setup.hanging``, ``mgtpu.setup.diagonal``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import setup_seconds  # noqa: E402

SPANS = ("mgtpu.setup.dofs", "mgtpu.setup.hanging", "mgtpu.setup.diagonal")


def read(run):
    return setup_seconds(run, SPANS)
