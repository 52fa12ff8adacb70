"""The program's own spans, as the per-layer metrics read them.

Solve path: the port names its work to a recording profiler with ranges
whose names start with ``mgtpu.`` (``dealii_multigrid_tpu_torch/utils/
phases.py``): ``mgtpu.<layer>.<part>``, ending in ``@L<level>`` where the
part has a level (``mgtpu.smoother.pre@L7``, ``mgtpu.operator.exchange``,
``mgtpu.cg.iteration``).  They are host events of the profiler window
(``Trace.host``), on the same clock as the CUDA runtime's calls there.  A
launch is such a call whose name starts with ``cudaLaunch`` or
``cuLaunch``, or a graph's launch (``cudaGraphLaunch``, ``cuGraphLaunch``:
one launch, whatever the graph holds); it belongs to a span when it
starts inside it, nested spans included.  A metric reads the launches inside the union of the spans it
selects, per CG iteration of the window.

Set-up: the port keeps its set-up spans in memory (``utils.phases.SETUP``:
seconds and count per path of span names).  A metric sums the self time
(seconds less the child spans') of the spans it names.

A program without these spans (one that predates them) gives None, and so
does a trace with no launch (a CPU run).
"""

from __future__ import annotations

import bisect
import sys

PREFIX = "mgtpu."
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
PRECONDITION = "mgtpu.vcycle.precondition"
CG_ITERATION = "mgtpu.cg.iteration"
PORT_SPANS = "dealii_multigrid_tpu_torch.utils.phases"


class Span:
    """One span of the trace: the ``part`` of its name after the layer, and
    its ``level`` (None where the name has none)."""

    __slots__ = ("name", "part", "level", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        body, _, level = name[len(PREFIX):].partition("@L")
        self.name, self.start, self.end = name, start, end
        self.part = body.partition(".")[2]
        self.level = int(level) if level.isdigit() else None


def spans(trace) -> list:
    return [Span(n, a, b) for n, a, b in trace.host if n.startswith(PREFIX)]


def launches(trace) -> list:
    """Start times of the window's launches, sorted."""
    return sorted(a for n, a, _ in trace.host if n.startswith(LAUNCH))


def count_inside(starts: list, chosen) -> int:
    """Launches (sorted start times) inside the union of the spans ``chosen``."""
    union: list = []
    for s in sorted(chosen, key=lambda s: s.start):
        if union and s.start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], s.end)
        else:
            union.append([s.start, s.end])
    return sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a) for a, b in union)


def launches_per_it(run, keep, minus=None):
    """Launches per CG iteration of the profiler window inside the spans for
    which ``keep(span)`` holds, less those inside the spans ``minus`` picks
    (which lie within the former); None where no span qualifies or the
    window launched nothing."""
    t = run.trace
    if t is None or not t.iterations:
        return None
    starts, found = launches(t), spans(t)
    chosen = [s for s in found if keep(s)]
    if not starts or not chosen:
        return None
    n = count_inside(starts, chosen)
    if minus is not None:
        n -= count_inside(starts, [s for s in found if minus(s)])
    return n / t.iterations


def is_phase(s: Span, *parts) -> bool:
    """A V-cycle phase span (it has a level) of one of ``parts``."""
    return s.level is not None and s.part in parts


def setup_seconds(run, names):
    """Self seconds of the set-up spans named ``names`` (full names), summed
    over every place they ran; None where the program keeps no set-up spans
    or none of these ran, or the run built nothing (no harness spans)."""
    port = sys.modules.get(PORT_SPANS)
    setup = getattr(port, "SETUP", None)
    if setup is None or not run.spans:
        return None
    totals = {r.parent + (r.name,): r.seconds for r in setup.records()}
    children: dict = {}
    for path, s in totals.items():
        children[path[:-1]] = children.get(path[:-1], 0.0) + s
    mine = [p for p in totals if p[-1] in names]
    if not mine:
        return None
    return sum(totals[p] - children.get(p, 0.0) for p in mine)
