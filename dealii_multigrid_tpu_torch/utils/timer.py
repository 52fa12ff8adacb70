"""Timers and memory monitoring.

ScopedTimer mirrors include/scoped_timer.h (RAII wall-clock accumulator);
monitor() mirrors the reference's VmPeak/VmSize/VmHWM/VmRSS checkpoints
(multigrid_throughput.cc:337-368), extended with the CUDA allocator's
statistics.
"""

from __future__ import annotations

import time


class ScopedTimer:
    """RAII wall-clock accumulator: adds the elapsed seconds to a slot.

    >>> acc = [0.0]
    >>> with ScopedTimer(acc): ...
    """

    def __init__(self, accumulator: list, index: int = 0):
        self._acc = accumulator
        self._idx = index

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._acc[self._idx] += time.perf_counter() - self._t0
        return False


def host_memory_stats() -> dict:
    """VmPeak/VmSize/VmHWM/VmRSS in MB from /proc/self/status."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                for key in ("VmPeak", "VmSize", "VmHWM", "VmRSS"):
                    if line.startswith(key + ":"):
                        out[key] = int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return out


def device_memory_stats() -> dict:
    """CUDA allocator statistics of the current device: bytes in use and
    their peak since the last reset.  Empty without a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    s = torch.cuda.memory_stats()
    return {
        f"cuda:{torch.cuda.current_device()}": {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
        }
    }


_MONITOR_ENABLED = False


def set_monitor(enabled: bool) -> None:
    global _MONITOR_ENABLED
    _MONITOR_ENABLED = enabled


def monitor(label: str) -> None:
    """Labelled memory checkpoint (disabled by default, like the reference's
    early-return monitor(), multigrid_throughput.cc:337-341)."""
    if not _MONITOR_ENABLED:
        return
    host = host_memory_stats()
    dev = "".join(
        f" {name}={st['bytes_in_use'] / 2**20:.0f}MB(peak {st['peak_bytes_in_use'] / 2**20:.0f}MB)"
        for name, st in device_memory_stats().items()
    )
    print(
        f"[monitor] {label}: "
        + " ".join(f"{k}={v:.0f}MB" for k, v in host.items())
        + dev
    )
