"""The harness's fenced span around the mesh and the level construction (s)."""


def read(run):
    return run.spans.get("hierarchy_s")
