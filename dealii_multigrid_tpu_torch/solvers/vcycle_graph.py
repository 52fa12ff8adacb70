"""A preconditioner application as one CUDA graph, captured once and replayed.

A V-cycle is thousands of small kernels (6,366 launches an iteration in
HMG-global at r=7 p=4), and eagerly the host's Python and dispatch, about
26 us a launch beside an H100, set the pace.  So ``PreconditionMG`` and
``PreconditionLS`` (``GraphedApplication``), built on a CUDA device, apply
themselves once eagerly on a zero vector (on a side stream: the kernel
library's shared-memory opt-in, cuBLAS's first calls), capture one
application into a ``torch.cuda.CUDAGraph`` in its own memory pool, and
replay it for each later application.

The graph's input and output are one static vector in the level dtype: a
call copies its argument in (the eager ``b.to(level dtype)``), replays, and
returns a fresh tensor in the outer dtype (a clone where the dtypes agree),
so that a caller may keep an output.  Every other tensor lives in the pool
only while the graph runs.  A replay runs the eager application's kernels
in the same order on the same values: the eager output bit for bit.

An application replays only where capture is sound.  Each object of the
V-cycle gives the first reason that holds of it (``graph_reason()``), or
None:

  * "hook": a phase hook other than ``utils.phases.untimed`` (the phase
    recorder, debug mode's check), the AMG coarse solve's included;
  * "sharded": a level, transfer or copy holds a rank communicator (its
    collectives cannot be captured);
  * "coarse": the coarse solve gives a reason (an inner CG reads back to
    the host), or does not answer;

and of a single application, which then runs eagerly:

  * "capturing": the stream is capturing already, so the application
    becomes part of the graph being captured (HPMG-local's LS V-cycle
    inside the p-levels' graph);
  * "input": the argument is not a plain tensor of the shape, dtype and
    device the preconditioner was built for.

On the CPU nothing is captured and nothing counted.  ``utils.phases.GRAPHS``
counts the captures, the replays and, per reason, the eager applications on
CUDA; ops/kernels.py counts each replay's kernel launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..ops import kernels
from ..utils.phases import (
    AMG_PHASES, GRAPH_REPLAY, GRAPHS, KEYS, PRECONDITION, VCYCLE_KEYS, hooked, span, untimed,
)

def reason_of(obj) -> str | None:
    """``obj.graph_reason()``; "coarse" where ``obj`` does not answer."""
    answer = getattr(obj, "graph_reason", None)
    return "coarse" if answer is None else answer()


def comm_reason(*parts) -> str | None:
    """"sharded" where one of ``parts`` holds a rank communicator."""
    return "sharded" if any(getattr(p, "comm", None) is not None for p in parts) else None


class VCycle:
    """What a V-cycle hierarchy (``Multigrid``, the local-smoothing ones)
    answers from its ``hook``, its ``coarse_solve`` and its ``parts()``."""

    def graph_reason(self) -> str | None:
        return ((None if self.hook is untimed else "hook") or comm_reason(*self.parts())
                or (None if reason_of(self.coarse_solve) is None else "coarse"))

    def with_hook(self, hook: Callable, phases: tuple = KEYS):
        """A copy whose phases, and an AMG coarse solve's (the only ones
        that nest inside ``cs``), run through ``hook``."""
        if set(VCYCLE_KEYS).isdisjoint(phases):
            return self
        return dataclasses.replace(self, hook=hook,
                                   coarse_solve=hooked(self.coarse_solve, hook, AMG_PHASES))


@dataclasses.dataclass
class VCycleGraph:
    """One preconditioner's graph, or the reason it has none (``reason``)."""

    reason: str | None
    outer_dtype: torch.dtype
    buf: torch.Tensor | None = None             # the static input and output (level dtype)
    graph: torch.cuda.CUDAGraph | None = None
    calls: dict = dataclasses.field(default_factory=dict)  # the capture's kernel calls

    @classmethod
    def prepare(cls, reason: str | None, body: Callable, like: torch.Tensor | None,
                level_dtype: torch.dtype, outer_dtype: torch.dtype) -> "VCycleGraph | None":
        """None off CUDA (``like``, a vector of the level's shape, is not on
        a card, or there is none); else the graph of ``body``, which
        overwrites its argument with the application's output, captured
        unless ``reason`` says why not."""
        if like is None or like.device.type != "cuda":
            return None
        if reason is not None:
            return cls(reason, outer_dtype)
        t0 = time.perf_counter()
        device = like.device
        buf = torch.zeros(like.shape, dtype=level_dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(buf)               # warm-up: every kernel loaded, every library initialised
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with kernels.recorded() as calls, torch.cuda.graph(graph, stream=side):
            body(buf)
        GRAPHS.captures += 1
        GRAPHS.capture_s += time.perf_counter() - t0
        return cls(None, outer_dtype, buf, graph, calls)

    def takes(self, b) -> bool:
        """Whether ``b``'s application replays; counts the eager one's reason."""
        reason = self.reason
        if reason is None:
            if torch.cuda.is_current_stream_capturing():
                reason = "capturing"
            elif not (type(b) is torch.Tensor and b.shape == self.buf.shape
                      and b.dtype == self.outer_dtype and b.device == self.buf.device):
                reason = "input"
        if reason is not None:
            GRAPHS.eager[reason] = GRAPHS.eager.get(reason, 0) + 1
            return False
        return True

    def replay(self, b: torch.Tensor) -> torch.Tensor:
        """The application to ``b`` (which ``takes``), a fresh tensor in the
        outer dtype, inside the span of a whole application."""
        buf = self.buf
        with span(PRECONDITION):
            buf.copy_(b)
            with span(GRAPH_REPLAY):
                self.graph.replay()
            GRAPHS.replays += 1
            kernels.add(self.calls)
            return buf.clone() if buf.dtype == self.outer_dtype else buf.to(self.outer_dtype)


class GraphedApplication:
    """What ``PreconditionMG`` and ``PreconditionLS`` share: frozen
    dataclasses with ``outer_dtype`` and a ``graph`` that is no init field
    (a ``dataclasses.replace`` copy decides anew), set by ``_prepare``;
    each gives ``graph_reason``, ``_hooked``, ``_apply`` and ``_eager``."""

    def _prepare(self, like: torch.Tensor | None, level_dtype: torch.dtype) -> None:
        object.__setattr__(self, "graph", VCycleGraph.prepare(
            self.graph_reason(), lambda b: b.copy_(self._apply(b)), like, level_dtype,
            self.outer_dtype,
        ))

    def with_hook(self, hook: Callable, phases: tuple = KEYS):
        """A copy whose V-cycle's phases run through ``hook``; itself where
        ``phases`` holds none of them (it serves as a coarse solve)."""
        return self if set(VCYCLE_KEYS).isdisjoint(phases) else self._hooked(hook)

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        graph = self.graph
        if graph is not None and graph.takes(b):
            return graph.replay(b)
        return self._eager(b)

    __call__ = vmult                # HPMG-local's LS V-cycle is a coarse solve
