"""Start the ranks of a sharded solve and bring rank 0's result back.

``launch(target, payload, world, device)`` spawns ``world`` processes
(``torch.multiprocessing``, start method ``spawn``: a child imports only
the package, never the caller's test module or JAX), joins them in one
gloo process group through a ``file://`` store in a fresh temporary
directory (a TCP port would race between concurrent test workers), and
runs ``target(payload, device)`` on every rank.  It returns rank 0's
return value.

  * Ranks always talk over gloo.  On a machine with one card every rank
    shares ``cuda:0`` and NCCL refuses two ranks on one GPU; where there is
    a card per rank, rank r takes ``cuda:r`` (still over gloo: the plans are
    built with CPU collectives).
  * The collectives get a timeout of their own (``collective_timeout``);
    the whole launch one more (``timeout``).
  * A CPU rank runs with one thread (``torch.set_num_threads(1)``).
  * A rank that raises sends its traceback; the parent then stops every
    rank and raises RuntimeError with it.  No process outlives the call.
  * The stencil kernel is built once in the parent before the spawn, so
    that the ranks load it and never race on ``nvcc``.

``target`` is a ``"module:function"`` string inside this package, so that
the spawned child can import it.
"""

from __future__ import annotations

import importlib
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a collective may wait for its peers before the rank raises
COLLECTIVE_TIMEOUT = 600.0


def rank_device(device: str, rank: int, world: int) -> torch.device:
    """A rank's device: the CPU when asked for, else ``cuda:rank`` where
    there is a card per rank and ``cuda:0`` otherwise (no rank carries on
    on the CPU when it finds no card)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank}: device {device!r} requested but torch.cuda.is_available() "
            "is False; the port does not fall back to the CPU"
        )
    n = torch.cuda.device_count()
    return torch.device(f"cuda:{rank}" if n >= world else "cuda:0")


def _resolve(target: str):
    mod, fn = target.split(":")
    return getattr(importlib.import_module(mod), fn)


def _rank_main(rank, world, store, device, target, payload, q, collective_timeout):
    ok = False
    try:
        dev = rank_device(device, rank, world)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=timedelta(seconds=collective_timeout),
        )
        out = _resolve(target)(payload, dev)
        # plain pickle: tensors travel by value, not as shared-memory handles
        # that die with this process
        q.put(("ok", rank, pickle.dumps(out) if rank == 0 else None))
        ok = True
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        q.put(("error", rank, traceback.format_exc()))
    finally:
        if ok and dist.is_initialized():
            dist.destroy_process_group()


def _prebuild(device: str) -> None:
    """Build the stencil kernel in the parent (once, before any spawn)."""
    if device != "cpu" and torch.cuda.is_available():
        from ..ops.patch_stencil import library

        library.build()


def launch(target: str, payload, world: int, device: str = "cuda",
           timeout: float = 3600.0, collective_timeout: float = COLLECTIVE_TIMEOUT):
    """Run ``target(payload, device)`` on ``world`` ranks; rank 0's result."""
    _prebuild(device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mgtpu-ranks-")
    store = os.path.join(tmp, "store")
    q = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(r, world, store, device, target, payload, q, collective_timeout),
            daemon=True,
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        result, done = None, set()
        deadline = time.monotonic() + timeout
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"sharded run did not finish within {timeout:.0f} s")
            try:
                kind, rank, out = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and not p.is_alive()]
                if dead:
                    # a rank that died without a word (killed): give its
                    # last message a moment to arrive, then fail
                    try:
                        kind, rank, out = q.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                            "without a result"
                        ) from None
                else:
                    continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            done.add(rank)
            if rank == 0:
                result = pickle.loads(out)
        for p in procs:
            p.join(timeout=60)
        return result
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        q.close()
        shutil.rmtree(tmp, ignore_errors=True)
