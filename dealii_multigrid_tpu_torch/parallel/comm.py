"""Collectives of a sharded solve: reductions in rank order and ghost imports.

The JAX package shards by placement and lets XLA's SPMD partitioner insert
the collectives (dealii_multigrid_tpu/parallel/sharding.py).  torch has no
partitioner, so the port writes the communication itself, in the shape of
deal.II's ``Utilities::MPI::Partitioner``:

  * ``SlotPart``: which span of one level's device-major slot vector this
    rank owns (the whole vector on a replicated level);
  * ``GhostImport``: a plan, built once on the host, of the remote slots a
    stage reads, the ranks that own them and where they land in the
    rank's ghost buffer; each call moves them in ONE ``all_to_all_single``
    (``update_ghost_values``), and none where no rank imports anything;
  * ``Comm.allsum``: a reduction that gathers every rank's partial sums and
    adds them in rank order, so that every rank holds the same bits (CG's
    scalars, the eigenvalue estimate and every convergence test steer
    control flow and must agree on all ranks).  A backend's ``all_reduce``
    leaves its order open and is not used.

Every collective of a stage is issued whether or not this rank sends or
receives anything: the sequence of collectives depends only on the global
tables, which every rank holds, so the ranks never wait on each other out
of step.  Plans are built with two small collectives on CPU tensors (the
counts, then the requested slot ids), which gloo takes on any rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


class Comm:
    """This rank's view of the process group (the default group of
    ``torch.distributed``, which the launcher or ``torchrun`` set up)."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    # ------------------------------------------------------------ gathers
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` (equal shapes), in rank
        order."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)

    def allsum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``partial``, added in rank order: the same
        bits on every rank."""
        parts = [torch.empty_like(partial) for _ in range(self.world)]
        dist.all_gather(parts, partial.contiguous())
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def alltoallv(self, send: torch.Tensor, send_counts: list, recv_counts: list) -> torch.Tensor:
        """``all_to_all_single`` with split sizes: ``send`` holds the
        elements for rank 0, then rank 1, ...; the result the elements from
        rank 0, then rank 1, ..."""
        out = send.new_empty(int(sum(recv_counts)))
        dist.all_to_all_single(out, send.contiguous(), recv_counts, send_counts)
        return out

    def host_alltoallv(self, send: np.ndarray, send_counts: np.ndarray):
        """Plan building: int64 ``send`` split by ``send_counts`` -> (what
        every rank sent here, concatenated in rank order; the counts; the
        number of elements all ranks send).  Where no rank sends anything
        the second collective is skipped on every rank."""
        sc = torch.as_tensor(np.asarray(send_counts, np.int64))
        rows = [torch.empty_like(sc) for _ in range(self.world)]
        dist.all_gather(rows, sc)
        matrix = torch.stack(rows).numpy()        # [from rank, to rank]
        rc = matrix[:, self.rank].copy()
        total = int(matrix.sum())
        if total == 0:
            return np.zeros(0, np.int64), rc, 0
        out = torch.empty(int(rc.sum()), dtype=torch.int64)
        dist.all_to_all_single(
            out, torch.as_tensor(np.ascontiguousarray(send, np.int64)),
            rc.tolist(), sc.tolist(),
        )
        return out.numpy(), rc, total


def current_comm() -> Comm:
    """The Comm of the initialized default process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a sharded level (n_shards > 1) needs an initialized process group: "
            "run it through parallel.launch or torchrun"
        )
    return Comm()


@dataclass(frozen=True)
class SlotPart:
    """This rank's part of one level's device-major slot vector: the span
    ``[lo, lo + span)``, with its patches ``[p_lo, p_lo + n_p)`` and
    singletons ``[s_lo, s_lo + n_s)``.  A replicated level (``shards`` 1)
    is owned whole by every rank."""

    shards: int
    rank: int
    n_slots: int
    span: int
    S: int
    nloc: int
    pps: int
    sps: int

    @classmethod
    def of(cls, fmt, rank: int) -> "SlotPart":
        D = fmt.n_shards
        if D == 1:
            return cls(1, rank, fmt.n_slots, fmt.n_slots, fmt.S, fmt.dofh.n_loc,
                       fmt.n_patches, fmt.n_singles)
        return cls(D, rank, fmt.n_slots, fmt.shard_span, fmt.S, fmt.dofh.n_loc,
                   fmt.patches_per_shard, fmt.singles_per_shard)

    @property
    def sharded(self) -> bool:
        return self.shards > 1

    @property
    def lo(self) -> int:
        return self.rank * self.span if self.sharded else 0

    @property
    def p_lo(self) -> int:
        return self.rank * self.pps if self.sharded else 0

    @property
    def s_lo(self) -> int:
        return self.rank * self.sps if self.sharded else 0

    def owner_of(self, g: np.ndarray) -> np.ndarray:
        g = np.asarray(g, np.int64)
        if not self.sharded:
            return np.full(g.shape, self.rank, np.int64)
        return g // self.span

    def own(self, g: np.ndarray) -> np.ndarray:
        g = np.asarray(g, np.int64)
        return (g >= self.lo) & (g < self.lo + self.span)

    def own_patch(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, np.int64)
        return (q >= self.p_lo) & (q < self.p_lo + self.pps)

    def own_single(self, j: np.ndarray) -> np.ndarray:
        j = np.asarray(j, np.int64)
        return (j >= self.s_lo) & (j < self.s_lo + self.sps)

    def slice(self, a):
        """The rank's span of a host array in the global slot layout."""
        return a[self.lo : self.lo + self.span]


class GhostImport:
    """One stage's ghost import: ``__call__(x)`` returns the values of the
    requested remote slots, in the order they were requested, from the
    ranks that own them (one ``all_to_all_single``)."""

    def __init__(self, comm: Comm | None, send_idx, send_counts, recv_counts,
                 unperm, slots: np.ndarray, device):
        self.comm = comm
        #: the requested global slots, in the order the call returns them
        self.slots = slots
        self.send_idx = torch.as_tensor(send_idx, dtype=torch.int64, device=device)
        self.send_counts = [int(c) for c in send_counts]
        self.recv_counts = [int(c) for c in recv_counts]
        self.unperm = torch.as_tensor(unperm, dtype=torch.int64, device=device)
        self.n_ghost = len(slots)

    @classmethod
    def build(cls, comm: Comm | None, part: SlotPart, want: np.ndarray, device) -> "GhostImport":
        """The plan that brings the slots ``want`` (global ids on the
        level of ``part``, unique, none of them owned here) to this rank.
        On a replicated level nothing is remote and no collective runs."""
        want = np.asarray(want, np.int64).reshape(-1)
        if not part.sharded:
            assert want.size == 0, "a replicated level has no ghosts"
            return cls(None, np.zeros(0), [], [], np.zeros(0), want, device)
        assert not part.own(want).any(), "an owned slot requested as a ghost"
        owner = part.owner_of(want)
        order = np.lexsort((want, owner))
        recv_counts = np.bincount(owner, minlength=comm.world)
        asked, send_counts, total = comm.host_alltoallv(want[order], recv_counts)
        assert part.own(asked).all(), "a rank asked for a slot it does not get here"
        unperm = np.empty(len(want), np.int64)
        unperm[order] = np.arange(len(want))
        # no rank imports anything: the stage needs no collective
        return cls(comm if total else None, asked - part.lo, send_counts, recv_counts,
                   unperm, want, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.comm is None:
            return x.new_zeros(0)
        recv = self.comm.alltoallv(x[self.send_idx], self.send_counts, self.recv_counts)
        return recv[self.unperm]


class ExtIndex:
    """Index tables of one stage rewritten to the rank's extended vector
    ``[own span | ghosts | 0]``: an owned slot maps to its place in the
    span, a remote one into the ghost buffer, a sentinel (>= n_slots) to
    the trailing zero.  ``build`` registers the table's slots; ``finish``
    makes the stage's one GhostImport and returns the mapper."""

    def __init__(self, part: SlotPart):
        self.part = part
        self._want: list = []

    def add(self, g: np.ndarray) -> None:
        g = np.asarray(g, np.int64).reshape(-1)
        g = g[(g < self.part.n_slots) & ~self.part.own(g)]
        self._want.append(g)

    def finish(self, comm: Comm | None, device) -> "ExtMap":
        want = np.unique(np.concatenate(self._want)) if self._want else np.zeros(0, np.int64)
        imp = GhostImport.build(comm, self.part, want, device)
        return ExtMap(self.part, want, imp)


class ExtMap:
    """global slot -> position in ``extend(x)``; see ExtIndex."""

    def __init__(self, part: SlotPart, ghosts: np.ndarray, imp: GhostImport):
        self.part = part
        self.ghosts = ghosts
        self.imp = imp

    @property
    def n_ext(self) -> int:
        return self.part.span + len(self.ghosts) + 1

    def __call__(self, g: np.ndarray) -> np.ndarray:
        g = np.asarray(g, np.int64)
        p = self.part
        out = np.full(g.shape, self.n_ext - 1, np.int64)
        own = p.own(g)
        out[own] = g[own] - p.lo
        rem = (~own) & (g < p.n_slots)
        if rem.any():
            pos = np.searchsorted(self.ghosts, g[rem])
            assert (self.ghosts[np.minimum(pos, len(self.ghosts) - 1)] == g[rem]).all()
            out[rem] = p.span + pos
        return out

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """``[x | ghost values | 0]``."""
        return torch.cat([x, self.imp(x), x.new_zeros(1)])
