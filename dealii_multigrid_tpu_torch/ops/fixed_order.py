"""Scatter-adds as fixed-order gathers.

``index_add_`` on CUDA adds with atomics: where several sources add into one
target, the order of that sum changes from run to run, so a float32 result
is not bit-repeatable.  ``FixedOrderSum`` is the replacement, the design of
the AMG restriction's transposed ELL table (solvers/amg.py):

  1. at set-up, a host table with one row per target lists that target's
     source positions in ascending order, padded to the widest row with the
     position of an explicit zero that the apply appends to the sources;
  2. at apply time, a gather ``[n_rows, width]`` and a sum along the row.

The sum along a row runs in one order on every run.  Where every target has
a source the rows are the targets themselves; otherwise the table lists the
targets it touches, and the row sums land there through ``index_add_`` over
unique targets: one addition per target, exact and repeatable.  A table of
width 1 (no target with two sources) is a single gather; one whose rows are
all full needs no appended zero.

In bfloat16 the sources add into the target one at a time, in ascending
order, each addition rounded: what a scatter-add computes (the JAX
package's ``.at[].add`` on its levels).  A row summed first (torch
accumulates a bfloat16 sum in float32 and rounds once) and then added
would round twice in all, and its bfloat16 value differs from the
scatter-add's in the last place often enough to move a solve's iteration
count (HMG-global quadrant r=4 p=4 under float: 5 iterations against the
JAX package's 4).
"""

from __future__ import annotations

import numpy as np
import torch


class FixedOrderSum:
    """``out[t] = sum of src[s] over the sources s with target t``, summed in
    ascending ``s``.  ``src`` may carry trailing dimensions."""

    def __init__(self, table: torch.Tensor, targets: torch.Tensor | None, n_target: int,
                 full: bool):
        self.table = table          # int64 [n_rows, width]; pad = len(src)
        self.targets = targets      # int64 [n_rows] unique, or None: row i is target i
        self.n_target = n_target
        self.full = full            # every row has width sources: no pad entry
        self.column = table[:, 0].contiguous() if table.shape[1] == 1 else None

    @classmethod
    def build(cls, target_of_source, n_target: int, device: torch.device) -> "FixedOrderSum":
        """The table of the scatter ``out[target_of_source[s]] += src[s]``;
        a negative target drops its source (a padding entry)."""
        t = np.asarray(target_of_source, np.int64).reshape(-1)
        order = np.argsort(t, kind="stable")
        order = order[t[order] >= 0]
        uniq, start, counts = np.unique(t[order], return_index=True, return_counts=True)
        width = int(counts.max()) if len(counts) else 1
        table = np.full((len(uniq), width), len(t), np.int64)
        rank = np.arange(len(order)) - np.repeat(start, counts)
        table[np.repeat(np.arange(len(uniq)), counts), rank] = order
        dense = len(uniq) == n_target
        return cls(
            torch.as_tensor(table, device=device),
            None if dense else torch.as_tensor(uniq, device=device),
            n_target,
            bool((counts == width).all()),
        )

    @property
    def width(self) -> int:
        return self.table.shape[1]

    @property
    def nbytes(self) -> int:
        n = self.table.numel() + (0 if self.targets is None else self.targets.numel())
        return 8 * n

    def rows(self, src: torch.Tensor) -> torch.Tensor:
        """The per-row sums ``[n_rows, ...]``."""
        if self.column is not None:
            return src[self.column]
        if not self.full:
            src = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
        return src[self.table].sum(dim=1)

    def add_into(self, out: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """In place: ``out[t] += sum of the row of t``; returns ``out``.  In
        bfloat16 one source at a time (see the module docstring)."""
        if src.dtype == torch.bfloat16 and self.column is None:
            return self._add_sequential(out, src)
        if self.targets is None:
            out += self.rows(src)
        else:
            out.index_add_(0, self.targets, self.rows(src))  # unique targets
        return out

    def _add_sequential(self, out: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """``out[t] = (((out[t] + s_1) + s_2) + ...)``, each sum rounded; a
        padded entry adds an exact zero."""
        if not self.full:
            src = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
        view = out if self.targets is None else out[self.targets]
        for j in range(self.width):
            view = view + src[self.table[:, j]]
        if self.targets is None:
            out.copy_(view)
        else:
            out[self.targets] = view  # unique targets
        return out

    def scatter(self, src: torch.Tensor) -> torch.Tensor:
        """A new tensor ``[n_target, ...]`` holding the sums (0 elsewhere)."""
        if self.targets is None and src.dtype != torch.bfloat16:
            return self.rows(src)
        return self.add_into(src.new_zeros((self.n_target,) + src.shape[1:]), src)
