"""Run one sweep of ``scripts/`` on the port and leave its table on disk.

    python -m dealii_multigrid_tpu_torch.tools.run_experiment <generator> [args]
        [--max-ref N] [--degree P ...] [--repetitions N] [--budget-s S]
        [--out PATH] [--device cuda|cpu] [--against RECORD ...] [--commit TEXT]

The port's counterpart of ``experiments/run_experiment.py``.  The generator
(a file of ``scripts/``, named with dashes or underscores; the remaining
positional arguments are its own) writes ``input_*.json`` files into a
temporary directory, with ``scripts/`` on ``PYTHONPATH``; each file goes
through ``cli.run_config`` on one device in this process, and the
cumulative table is rewritten after every config.

``--max-ref`` leaves out configs with NRefGlobal above N; ``--degree``
(repeatable) keeps only configs of those fine degrees; ``--repetitions``
sets every config's NRepetitions (the timed solves after the warm-up;
the counts do not depend on it); ``--budget-s``
leaves out the configs after the wall-clock budget is spent; a config that
raises loses its row.  Each of these lands on a ``#`` line of the artifact.
A config with ``NShards`` above 1 runs domain-decomposed over that many
ranks (api.dispatch_solve starts them; on a card they share it).

The runs go to ``cuda:0`` unless ``--device cpu`` is given; without a card
the default raises.  The artifact is ``results/torch-h100/<generator>
[-args].txt`` on the card and ``results/torch-cpu/...`` on the CPU; its
first line gives the device (the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them), the
commit and the date, and every row ends with a ``device`` column.  These
files are never merged with the TPU records.

``--against RECORD`` (repeatable) holds each row's iteration count to the
rows of a table of ``results/`` that have the same type, geometry, degree,
n_ref_global, min_level, mg_number, coarse_type, n_cycles, smoother_deg and
reltol (a column a record does not have, or leaves empty, is not
compared).  Times in a record are never compared.  Each row gets
``equal``, ``differs (port n, record m)``, ``ambiguous`` or ``no record``
(``compare_rows``), printed and written to the artifact with a count of
each.

A record without an ``n_shards`` column cannot tell a sweep's shard
counts apart by its columns; its rows are in config order, so the
partition-quality columns of a sharded row (``PARTITION_COLUMNS``) are held
to the record's row of the same config number, as printed
(``compare_partitions``; ``partitions equal`` or ``partitions differ``).
An unsharded row's columns describe one rank here and are not compared.

The exit code is 1 when a row differs from its record (its iteration count
or, on a sharded row, its partition columns) or a config failed, else 0.
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..cli import run_config
from ..utils.device import resolve_device
from ..utils.params import RunParameters
from ..utils.table import ConvergenceTable

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCRIPTS = os.path.join(REPO, "scripts")
VERDICTS = ("equal", "differs", "ambiguous", "none")
#: the columns that identify a row when it is held to a record
KEYS = ("type", "geometry", "degree", "n_ref_global", "min_level", "mg_number",
        "coarse_type", "n_cycles", "smoother_deg", "reltol")
#: the columns of the MG statistics that describe the partition of a run
PARTITION_COLUMNS = ("sub_comm_size", "workload_eff", "workload_path_max",
                     "workload_path_max_node", "vertical_eff", "horizontal_eff")


def find_generator(name: str) -> str:
    for cand in (name, name.replace("-", "_"), name.replace("_", "-")):
        path = os.path.join(SCRIPTS, cand + ".py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no generator scripts/{name}.py")


def device_line(device: torch.device) -> str:
    """``cpu``, or the card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def git_commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown (not a git checkout)"
    return out.stdout.strip()


# --------------------------------------------------------------- records


def parse_tables(text: str) -> list[dict]:
    """Every row of every table in a results file, as a dict of its cells.
    A header starts with ``dim``; cells are cut at the header's column
    offsets, so an empty cell stays empty; ``#`` lines are skipped."""
    rows, header = [], None
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        if line.startswith("dim "):
            names = line.split()
            starts, pos = [], 0
            for nm in names:
                pos = line.index(nm, pos)
                starts.append(pos)
                pos += len(nm)
            header = (names, starts, starts[1:] + [None])
            continue
        if header is not None:
            names, starts, ends = header
            rows.append({nm: line[a:b].strip() for nm, a, b in zip(names, starts, ends)})
    return rows


def _same(a, b) -> bool:
    a, b = str(a).strip(), str(b).strip()
    try:
        return float(a) == float(b)
    except ValueError:
        return a == b


def _cell(row: dict, key: str) -> str:
    return ConvergenceTable._format(row[key]) if key in row else ""


def compare_rows(rows: list[dict], record: list[dict]) -> list[tuple[str, str]]:
    """Per port row: (verdict, description).  The verdict is ``equal`` (every
    matching record row has the port's count), ``differs`` (none has it),
    ``ambiguous`` (the matching rows disagree among themselves, one of them
    with the port: a record without the identity columns cannot tell the
    rows of a parameter sweep apart) or ``none`` (no matching row)."""
    out = []
    for row in rows:
        found = [
            rec for rec in record
            if all(not rec.get(k) or _same(rec[k], _cell(row, k)) for k in KEYS)
        ]
        n = int(row["n_iterations"])
        ident = (f"{_cell(row, 'type')} {_cell(row, 'geometry')} p={_cell(row, 'degree')} "
                 f"r={_cell(row, 'n_ref_global')} mg={_cell(row, 'mg_number')} "
                 f"{_cell(row, 'coarse_type')}x{_cell(row, 'n_cycles')} "
                 f"sm={_cell(row, 'smoother_deg')} tol={_cell(row, 'reltol')}")
        counts = sorted({int(rec["n_iterations"]) for rec in found if rec.get("n_iterations")})
        if not counts:
            out.append(("none", f"{ident}: no record (port {n})"))
        elif counts == [n]:
            out.append(("equal", f"{ident}: equal ({n})"))
        elif n in counts:
            out.append(("ambiguous", f"{ident}: ambiguous (port {n}, record rows without its "
                                     f"identity columns {'/'.join(map(str, counts))})"))
        else:
            out.append(("differs", f"{ident}: differs (port {n}, record "
                                   f"{'/'.join(map(str, counts))})"))
    return out


def compare_partitions(rows: list[dict], names: list[str], record: list[dict]) -> list:
    """Per row of a sharded config: (config, verdict, description), the row
    held to the record's row of the same config number (``input_NNNN``) on
    ``PARTITION_COLUMNS``, as printed."""
    out = []
    for row, name in zip(rows, names):
        i = int(name[len("input_"):len("input_") + 4])
        rec = record[i] if i < len(record) else None
        if rec is None or not all(not rec.get(k) or _same(rec[k], _cell(row, k)) for k in KEYS):
            out.append((name, "none", "partitions: no record row of this config"))
            continue
        bad = [f"{k} port {_cell(row, k)} record {rec.get(k, '')}"
               for k in PARTITION_COLUMNS if not _same(rec.get(k, ""), _cell(row, k))]
        out.append((name, "differ" if bad else "equal",
                    "partitions differ (" + "; ".join(bad) + ")" if bad else "partitions equal"))
    return out


# ------------------------------------------------------------------ runs


@dataclass
class Sweep:
    """What one run of the runner did."""

    out_path: str
    rows: list = field(default_factory=list)        # the table's rows (dicts)
    ran: list = field(default_factory=list)         # (config, seconds)
    failed: list = field(default_factory=list)      # "config: error"
    skipped_ref: list = field(default_factory=list)
    skipped_degree: list = field(default_factory=list)
    skipped_budget: list = field(default_factory=list)
    verdicts: list = field(default_factory=list)    # (record, config, verdict, text)
    partitions: list = field(default_factory=list)  # (record, config, verdict, text)

    def count(self, verdict: str) -> int:
        return sum(v == verdict for _, _, v, _ in self.verdicts)


def run_experiment(
    experiment: str, gen_args: list[str], device: str | torch.device | None = None,
    out: str | None = None, max_ref: int | None = None, budget_s: float = 1800.0,
    against: list[str] | None = None, commit: str | None = None,
    degrees: list[int] | None = None, repetitions: int | None = None,
) -> Sweep:
    """Generate the sweep, run every config, write the artifact; returns
    what happened."""
    device = resolve_device(device)
    gen = find_generator(experiment)
    stem = os.path.basename(gen)[:-3]
    era = "torch-h100" if device.type == "cuda" else "torch-cpu"
    out_path = out or os.path.join(REPO, "results", era, "-".join([stem, *gen_args]) + ".txt")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    dev_line = device_line(device)
    head = (f"# device: {dev_line} | commit: {commit or git_commit()} | date: "
            f"{time.strftime('%Y-%m-%d %H:%M:%S %Z')}")
    records = {path: parse_tables(open(path).read()) for path in against or []}
    sweep = Sweep(out_path)
    table = ConvergenceTable()
    names: list[str] = []    # the config of each table row
    sharded: list[bool] = []  # whether that config ran on more than one rank
    t0 = time.time()

    def write() -> None:
        buf = io.StringIO()
        if table.rows:
            table.write_text(buf)
        with open(out_path, "w") as f:
            f.write(head + "\n")
            f.write(f"# experiment: {os.path.basename(gen)} {' '.join(gen_args)} (the PyTorch "
                    f"port, dealii_multigrid_tpu_torch; elapsed {time.time() - t0:.0f} s)\n")
            for nm, dt in sweep.ran:
                f.write(f"# ran {nm} in {dt:.1f} s\n")
            f.write(buf.getvalue())
            if sweep.skipped_ref:
                f.write(f"# SKIPPED (--max-ref {max_ref}): {', '.join(sweep.skipped_ref)}\n")
            if sweep.skipped_degree:
                f.write(f"# SKIPPED (--degree {' '.join(map(str, degrees))}): "
                        f"{', '.join(sweep.skipped_degree)}\n")
            if sweep.skipped_budget:
                f.write(f"# SKIPPED (budget {budget_s:.0f} s spent): "
                        f"{', '.join(sweep.skipped_budget)}\n")
            for msg in sweep.failed:
                f.write(f"# FAILED {msg}\n")
            for rec, cfg, _, text in sweep.verdicts + sweep.partitions:
                f.write(f"# against {os.path.relpath(rec, REPO)}: {cfg} {text}\n")
            for rec in records:
                f.write(f"# against {os.path.relpath(rec, REPO)}: "
                        + ", ".join(f"{sum(v == w for r, _, v, _ in sweep.verdicts if r == rec)} {w}"
                                    for w in VERDICTS) + "\n")

    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ)
        env["PYTHONPATH"] = SCRIPTS + os.pathsep + env.get("PYTHONPATH", "")
        subprocess.run([sys.executable, gen, *gen_args], cwd=work, env=env, check=True)
        configs = sorted(glob.glob(os.path.join(work, "input_*.json")))
        if not configs:
            raise RuntimeError(f"{gen} wrote no input_*.json")
        parsed = [(os.path.basename(c), RunParameters.parse(c)) for c in configs]
    for name, params in parsed:
        if max_ref is not None and params.n_ref_global > max_ref:
            sweep.skipped_ref.append(name)
            continue
        if degrees and params.fe_degree_fine not in degrees:
            sweep.skipped_degree.append(name)
            continue
        if time.time() - t0 > budget_s and sweep.ran:
            sweep.skipped_budget.append(name)
            continue
        if repetitions is not None:
            params.mg_data.n_repetitions = repetitions
        t_cfg = time.time()
        n_rows = len(table.rows)
        try:
            run_config(params, table, device)
            table.add_value("device", dev_line)
        except Exception as exc:  # noqa: BLE001 - the sweep goes on; the row is dropped
            del table.rows[n_rows:]
            table._current = None
            sweep.failed.append(f"{name}: {type(exc).__name__}: {exc}")
            print(f"FAILED {name}: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        else:
            sweep.ran.append((name, time.time() - t_cfg))
            names.append(name)
            sharded.append(params.n_shards > 1)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        write()
    sweep.rows = table.rows
    for rec, record in records.items():
        for name, (verdict, text) in zip(names, compare_rows(table.rows, record)):
            sweep.verdicts.append((rec, name, verdict, text))
        picked = [(row, nm) for row, nm, sh in zip(table.rows, names, sharded) if sh]
        if picked:
            for name, verdict, text in compare_partitions(
                [r for r, _ in picked], [n for _, n in picked], record
            ):
                sweep.partitions.append((rec, name, verdict, text))
    write()
    return sweep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dealii_multigrid_tpu_torch.tools.run_experiment",
        description="Run a sweep generator of scripts/ on the port.",
    )
    ap.add_argument("experiment", help="generator name, e.g. small-scaling")
    ap.add_argument("gen_args", nargs="*", help="arguments for the generator")
    ap.add_argument("--out", default=None, help="artifact path")
    ap.add_argument("--budget-s", type=float, default=1800.0)
    ap.add_argument("--max-ref", type=int, default=None,
                    help="leave out configs with NRefGlobal above this")
    ap.add_argument("--degree", type=int, action="append", default=None,
                    help="keep only configs of this fine degree (repeatable)")
    ap.add_argument("--repetitions", type=int, default=None,
                    help="every config's NRepetitions (timed solves after the warm-up)")
    ap.add_argument("--device", default=None, help="cuda (the default: cuda:0) or cpu")
    ap.add_argument("--against", action="append", default=[],
                    help="a results table to hold the iteration counts to (repeatable)")
    ap.add_argument("--commit", default=None,
                    help="the commit for the header (default: git rev-parse HEAD)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = "cuda:0" if args.device in (None, "cuda") else args.device
    sweep = run_experiment(
        args.experiment, args.gen_args, device, args.out, args.max_ref, args.budget_s,
        args.against, args.commit, args.degree, args.repetitions,
    )
    for rec, cfg, _, text in sweep.verdicts + sweep.partitions:
        print(f"{os.path.relpath(rec, REPO)}: {cfg} {text}")
    n_part = {v: sum(w == v for _, _, w, _ in sweep.partitions) for v in ("equal", "differ", "none")}
    print(f"{sweep.out_path}: {len(sweep.ran)} ran, {len(sweep.failed)} failed, "
          f"{len(sweep.skipped_ref)} skipped by --max-ref, {len(sweep.skipped_degree)} by "
          f"--degree, {len(sweep.skipped_budget)} by the "
          f"budget; against records: "
          + ", ".join(f"{sweep.count(v)} {v}" for v in VERDICTS)
          + (f"; sharded rows' partitions: {n_part['equal']} equal, {n_part['differ']} differ, "
             f"{n_part['none']} none" if sweep.partitions else ""))
    return 1 if sweep.failed or sweep.count("differs") or n_part["differ"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
