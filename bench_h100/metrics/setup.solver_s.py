"""Self seconds of the port's solver set-up spans: transfers, eigenvalue
estimates, the coarse solver and the global-coarsening preconditioner's own
work, its smoothers (``mgtpu.setup.transfer``, ``mgtpu.setup.eigenvalues``,
``mgtpu.setup.coarse``, ``mgtpu.setup.gc_preconditioner``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import setup_seconds  # noqa: E402

SPANS = ("mgtpu.setup.transfer", "mgtpu.setup.eigenvalues", "mgtpu.setup.coarse",
         "mgtpu.setup.gc_preconditioner")


def read(run):
    return setup_seconds(run, SPANS)
