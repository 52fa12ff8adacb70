"""ConvergenceTable equivalent: one row per benchmark run, pretty-printed.

Mirrors dealii::ConvergenceTable as used by the reference executable
(multigrid_throughput.cc:2420-2442): columns accumulate across runs and the
full table is re-printed after each run.
"""

from __future__ import annotations

import sys


class ConvergenceTable:
    def __init__(self):
        self.rows: list[dict] = []
        self._current: dict | None = None

    def new_row(self) -> None:
        self._current = {}
        self.rows.append(self._current)

    def add_value(self, key: str, value) -> None:
        if self._current is None:
            self.new_row()
        self._current[key] = value

    @staticmethod
    def _format(v) -> str:
        if isinstance(v, float):
            if v == 0:
                return "0"
            if abs(v) >= 1e5 or abs(v) < 1e-3:
                return f"{v:.3e}"
            return f"{v:.4g}"
        return str(v)

    def to_text(self) -> str:
        if not self.rows:
            return ""
        cols: list[str] = []
        for row in self.rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        cells = [[self._format(r.get(c, "")) for c in cols] for r in self.rows]
        widths = [
            max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(cols)
        ]
        lines = [" ".join(c.ljust(w) for c, w in zip(cols, widths))]
        for row in cells:
            lines.append(" ".join(v.ljust(w) for v, w in zip(row, widths)))
        return "\n".join(lines)

    def write_text(self, stream=None) -> None:
        print(self.to_text(), file=stream or sys.stdout)
