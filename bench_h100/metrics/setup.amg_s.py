"""Self seconds of the port's AMG set-up spans: the host hierarchy and ELL
tables, their upload, and the dense Cholesky factor
(``mgtpu.setup.amg_build``, ``.amg_upload``, ``.amg_factor``, inside
``mgtpu.setup.coarse``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import setup_seconds  # noqa: E402

SPANS = ("mgtpu.setup.amg_build", "mgtpu.setup.amg_upload", "mgtpu.setup.amg_factor")


def read(run):
    return setup_seconds(run, SPANS)
