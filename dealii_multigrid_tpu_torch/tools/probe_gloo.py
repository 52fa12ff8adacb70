"""Which collectives gloo takes, by device and dtype, for the sharded solves.

    python3 dealii_multigrid_tpu_torch/tools/probe_gloo.py [--ranks N]

Starts N ranks (default 2) in one gloo group and tries ``all_gather`` and
``all_to_all_single`` (equal and unequal splits) on tensors of float64,
float32, bfloat16, int16 and int64, on the CPU and, where there is a card,
on ``cuda:0`` (every rank on the same card, as the port's launcher places
them).  Rank 0 prints one line per device and dtype: ``ok`` or the error.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = (torch.float64, torch.float32, torch.bfloat16, torch.int16, torch.int64)


def _collectives(rank: int, world: int):
    def gather(t):
        dist.all_gather([torch.empty_like(t) for _ in range(world)], t)

    def even(t):
        out = t.new_empty(2 * world)
        dist.all_to_all_single(out, t.repeat(world), [2] * world, [2] * world)

    def uneven(t):
        # rank r sends r + 1 elements to every rank
        send = t.new_ones(world * (rank + 1))
        out = t.new_empty(sum(q + 1 for q in range(world)))
        dist.all_to_all_single(out, send, [q + 1 for q in range(world)], [rank + 1] * world)

    return (("all_gather", gather), ("all_to_all_single", even),
            ("all_to_all_single uneven", uneven))


def _rank(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    devices = ["cpu"] + (["cuda:0"] if torch.cuda.is_available() else [])
    for dev in devices:
        for dtype in DTYPES:
            verdicts = []
            for name, fn in _collectives(rank, world):
                try:
                    fn(torch.ones(2, dtype=dtype, device=dev))
                    verdicts.append(f"{name}: ok")
                except RuntimeError as exc:  # the verdict is the point of the probe
                    verdicts.append(f"{name}: {str(exc).splitlines()[0][:80]}")
            if rank == 0:
                print(f"{dev} {str(dtype).replace('torch.', '')}: " + "; ".join(verdicts), flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.ranks, os.path.join(tmp, "store")),
                           nprocs=args.ranks, start_method="spawn")


if __name__ == "__main__":
    main()
