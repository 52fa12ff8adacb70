"""Self seconds of the port's layout set-up spans, every level: hybrid
formats, operator tables and their upload, and local smoothing's host levels
(``mgtpu.setup.hybrid_format``, ``mgtpu.setup.hybrid_operator``,
``mgtpu.setup.ls_level``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import setup_seconds  # noqa: E402

SPANS = ("mgtpu.setup.hybrid_format", "mgtpu.setup.hybrid_operator", "mgtpu.setup.ls_level")


def read(run):
    return setup_seconds(run, SPANS)
