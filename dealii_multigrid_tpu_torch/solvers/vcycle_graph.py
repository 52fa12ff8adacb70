"""A preconditioner application as one CUDA graph, captured once and replayed.

A V-cycle is thousands of small kernels (6,366 launches an iteration in
HMG-global at r=7 p=4), and eagerly the host's Python and dispatch, about
26 us a launch beside an H100, set the pace.  So ``PreconditionMG`` and
``api.PreconditionLS``, when they are built on a CUDA device, apply
themselves once eagerly on a zero vector (on a side stream: the kernel
library's shared-memory opt-in, cuBLAS's first calls) and then capture one
whole application into a ``torch.cuda.CUDAGraph``, in its own memory pool.
Each later application is one replay.

The graph reads its input from, and writes its output to, one static
vector in the level dtype: a call copies its argument in (the cast the
eager ``b.to(level dtype)`` makes), replays, and returns a fresh tensor in
the outer dtype, a clone where the two dtypes agree, so that a caller may
keep an output while later applications run.  After the capture nothing
but that vector stays allocated; every other tensor of the application
lives in the pool only while the graph runs.  A replay runs the eager
application's kernels in the same order on the same values, so it gives
the eager output bit for bit.

An application replays only where capture is sound, which the objects
themselves show; any other runs eagerly, exactly as without a graph:

  * "hook": a phase hook other than ``utils.phases.untimed`` (the phase
    recorder, debug mode's check) times or checks each phase, the AMG
    coarse solve's included;
  * "sharded": a level, transfer or copy holds a rank communicator (its
    collectives cannot be captured);
  * "coarse": the coarse solve may read back to the host (an inner CG) or
    is of a kind this module does not know;
  * "capturing": the stream is capturing already, so the application
    becomes part of the graph being captured (HPMG-local's LS V-cycle
    inside the p-levels' graph);
  * "input": the argument is not a plain tensor of the shape, dtype and
    device the preconditioner was built for.

On the CPU nothing is captured and nothing counted.  ``utils.phases.GRAPHS``
counts the captures, the replays and, per reason, the eager applications on
CUDA.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..utils.phases import GRAPH_REPLAY, GRAPHS, span, untimed
from .amg import AMGPreconditioner
from .coarse import DirectCoarseSolver, SlottedSolver, find_amg


def _has_comm(obj) -> bool:
    """``obj`` (or its operator) exchanges with other ranks."""
    return any(getattr(o, "comm", None) is not None for o in (obj, getattr(obj, "op", None)))


def _device_only(solve) -> bool:
    """The coarse solve runs on the device alone, with no read to the host."""
    if isinstance(solve, SlottedSolver):
        return _device_only(solve.inner)
    if isinstance(solve, (DirectCoarseSolver, AMGPreconditioner)):
        return True
    reason = getattr(solve, "graph_reason", None)  # a preconditioner as coarse solve
    return reason is not None and reason() is None


def static_reason(hooks, parts, coarse) -> str | None:
    """Why a preconditioner with the phase ``hooks``, the level objects
    ``parts`` (operators, transfers, level copies) and the ``coarse`` solve
    cannot be captured, or None where it can."""
    amg = find_amg(coarse)
    if any(h is not untimed for h in (*hooks, getattr(amg, "hook", untimed))):
        return "hook"
    if any(_has_comm(p) for p in parts) or _has_comm(coarse):
        return "sharded"
    if not _device_only(coarse):
        return "coarse"
    return None


class VCycleGraph:
    """One preconditioner's graph, or the reason it has none (``reason``)."""

    def __init__(self, reason: str | None, outer_dtype: torch.dtype,
                 buf: torch.Tensor | None = None, graph: torch.cuda.CUDAGraph | None = None,
                 stencil: dict | None = None, step: dict | None = None):
        self.reason = reason
        self.outer_dtype = outer_dtype
        self.buf = buf              # the static input and output (level dtype)
        self.graph = graph
        self.stencil = stencil or {}  # patch-stencil calls the capture recorded, per dtype
        self.step = step or {}      # Chebyshev step kernel calls it recorded, per dtype

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
        from ..ops import chebyshev_step, patch_stencil

        t0 = time.perf_counter()
        device = like.device
        buf = torch.zeros(like.shape, dtype=level_dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(buf)               # warm-up: every kernel loaded, every library initialised
        torch.cuda.current_stream(device).wait_stream(side)
        counters = (patch_stencil.captured, chebyshev_step.captured)
        before = [dict(c.per_dtype) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            body(buf)
        stencil, step = (
            {k: n - was.get(k, 0) for k, n in c.per_dtype.items() if n != was.get(k, 0)}
            for c, was in zip(counters, before)
        )
        GRAPHS.captures += 1
        GRAPHS.capture_s += time.perf_counter() - t0
        return cls(None, outer_dtype, buf, graph, stencil, step)

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
        outer dtype."""
        buf = self.buf
        buf.copy_(b)
        with span(GRAPH_REPLAY):
            self.graph.replay()
        GRAPHS.replays += 1
        for recorded, total in ((self.stencil, GRAPHS.stencil), (self.step, GRAPHS.step)):
            for k, n in recorded.items():
                total[k] = total.get(k, 0) + n
        return buf.clone() if buf.dtype == self.outer_dtype else buf.to(self.outer_dtype)
