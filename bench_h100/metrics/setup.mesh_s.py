"""Self seconds of the port's mesh set-up spans: the mesh, its geometric
coarsening sequence and local smoothing's level meshes
(``mgtpu.setup.mesh``, ``mgtpu.setup.coarsening``, ``mgtpu.setup.level_mesh``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import setup_seconds  # noqa: E402

SPANS = ("mgtpu.setup.mesh", "mgtpu.setup.coarsening", "mgtpu.setup.level_mesh")


def read(run):
    return setup_seconds(run, SPANS)
