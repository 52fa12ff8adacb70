"""The traced window: a ``torch.profiler`` window (CPU and CUDA activities)
over a few solves, reduced in memory to what the per-layer metrics and the
result's ``breakdown`` read.  No trace file is written."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float                       # host span of the traced solves
    iterations: int                       # CG iterations in them
    device: list = field(default_factory=list)   # (name, start_s, end_s)
    host: list = field(default_factory=list)     # (name, start_s, end_s)

    def kernels(self) -> list:
        """Device events that are kernels (not copies or memsets)."""
        return [e for e in self.device if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        """Length of the union of the device's activity intervals."""
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def gaps(self) -> list:
        """Idle intervals between device activity, (start_s, end_s)."""
        out, end = [], None
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host operation running at their middle."""
        per_op: dict = {}
        for name, a, b in self.device:
            per_op[name] = per_op.get(name, 0.0) + (b - a)
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host, key=lambda e: e[1])
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in longest:
            mid = 0.5 * (a + b)
            inside = [e for e in host if e[1] <= mid <= e[2]]
            name = min(inside, key=lambda e: e[2] - e[1])[0] if inside else "host (no operator)"
            named.append([name, b - a])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return fn() if fn is not None else 1000 * getattr(event, f"{what}_us")()


def traced(run_solves, sync) -> Trace:
    """Run ``run_solves()`` (it returns the CG iterations it ran) inside a
    profiler window and reduce the events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        iterations = run_solves()
        sync()
        window = time.perf_counter() - t0
    trace = Trace(window, iterations)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start") * 1e-9
        rec = (e.name(), start, start + _ns(e, "duration") * 1e-9)
        (trace.device if e.device_type() == cuda else trace.host).append(rec)
    return trace
