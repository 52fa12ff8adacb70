"""One run of one cell: set-up, a closed-loop window of back-to-back solves,
the per-layer readings of a traced run, and the check of the sampled
solves against the plain reference.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic, ``configs/<config>.json`` holds the
solver deployment, ``traffic/<traffic>.json`` the problem and its loads,
``limits/<cell>.json`` the limits of the numbers the check compares, and
``metrics/<metric>.py`` the reader of each metric.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "dealii_multigrid_tpu")
GIB = float(1 << 30)


def process_start(fallback: float) -> float:
    """The ``time.perf_counter`` reading at which this process started
    (``fallback`` where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        now, boot = time.perf_counter(), time.clock_gettime(time.CLOCK_BOOTTIME)
        return now - (boot - started)
    except (OSError, ValueError, IndexError):
        return fallback


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    bench: dict
    workload: dict
    config_entry: dict
    config: dict
    traffic: dict
    limits: dict

    @classmethod
    def find(cls, name: str) -> "Cell":
        from . import traffic as tr

        bench = _read_json(os.path.join(ROOT, "BENCHMARK.json"))
        workload = next((w for w in bench["workloads"] if w["name"] == name), None)
        if workload is None:
            raise ValueError(f"BENCHMARK.json has no workload {name!r}")
        entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
        return cls(
            name, bench, workload, entry,
            _read_json(os.path.join(ROOT, entry["file"])),
            tr.load(os.path.join(HERE, "traffic", f"{workload['traffic']}.json")),
            _read_json(os.path.join(HERE, "limits", f"{name}.json")),
        )

    def params(self):
        """The port's RunParameters of the configuration on this traffic's
        mesh (the deal.II benchmark's JSON keys)."""
        from dealii_multigrid_tpu_torch.utils.params import RunParameters

        raw = dict(self.config["solver"])
        raw.update(self.traffic["mesh"])
        return RunParameters.from_dict(raw)

    def _applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def metrics(self, trace: bool) -> list:
        """The cell's end-to-end metrics, or (traced) its per-layer ones."""
        e2e = [m for m in self.bench["end_to_end"] if self._applies(m)]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [
            m for m in self.bench["per_layer"]
            if (self.name in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    n_dofs: int
    setup_s: float = 0.0
    window_s: float = 0.0
    solve_s: list = field(default_factory=list)
    iterations: list = field(default_factory=list)
    converged: list = field(default_factory=list)
    peak_bytes: int = 0
    spans: dict = field(default_factory=dict)
    probe_s: list = field(default_factory=list)  # host_probe() after each solve (traced)
    phases: dict | None = None      # phase -> seconds over the window (traced)
    trace: object = None            # lib.trace.Trace (traced)
    entries: list = field(default_factory=list)
    local_smoothing: bool = False

    def phase_ms_per_it(self, phases=None):
        """The recorded V-cycle phases ``phases`` (all where None) per CG
        iteration of the window (ms); None in an untraced run."""
        if not self.phases or not self.iterations:
            return None
        keys = self.phases if phases is None else phases
        return 1e3 * sum(self.phases.get(k, 0.0) for k in keys) / sum(self.iterations)


def host_probe(n: int = 20000) -> float:
    """Seconds of a fixed pure-Python loop: the host CPU's speed at that
    moment, which sets the pace of the host-dispatched solves."""
    t, acc = time.perf_counter(), 0
    for i in range(n):
        acc += i
    return time.perf_counter() - t


def read_metric(name: str, run: Run):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            log=print) -> dict:
    """One run on ``device``; returns the result object (without printing)."""
    import torch

    from . import check as chk
    from .system import System
    from .trace import traced
    from .traffic import Loads

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from dealii_multigrid_tpu_torch.utils.phases import PhaseRecorder

    params = cell.params()
    loads = Loads(cell.traffic, seed)
    system = System(params, device)
    t_built = time.perf_counter()
    run = Run(n_dofs=int(cell.traffic["n_dofs"]), spans=dict(system.spans),
              entries=list(system.entries), local_smoothing=system.lsmg is not None)
    if system.n_dofs != run.n_dofs:
        log(f"[bench] the port's n_dofs {system.n_dofs} differs from the traffic's {run.n_dofs}")

    def fresh():
        rec = PhaseRecorder(device) if trace else None
        return rec, (system.instrumented(rec) if trace else system.wrapper)

    recorder, precond = fresh()

    def solve(b):
        if recorder is None:
            return system.solve(b, precond)
        return recorder.span(lambda: system.solve(b, precond))[0]

    t_warm = time.perf_counter()
    solve(system.rhs(*loads.pair(-1)))  # warm-up: every shape of the window
    sync()
    recorder, precond = fresh()
    # the set-up's heap out of the collector's way: a full collection over
    # it stalls the window for ~0.12 s (cell quadrant_r7); younger objects
    # are still collected
    gc.collect()
    gc.freeze()
    t_open = time.perf_counter()
    run.setup_s = t_open - t_start
    split = dict(run.spans, before_s=t_built - sum(run.spans.values()) - t_start,
                 warmup_s=t_open - t_warm)

    raw = []  # (index, alpha, beta, x, z, claimed) with host copies of slot vectors
    unconverged = 0
    last = max(loads.checked)
    deadline, k, t_close = t_open + seconds, 0, t_open
    tail = None  # the window's latest solve: (index, alpha, beta, result)
    while True:
        in_window = time.perf_counter() < deadline
        if not in_window and k > last:
            break
        alpha, beta = loads.pair(k)
        checked = k in loads.checked
        precond.armed = checked
        b = system.rhs(alpha, beta)
        t0 = time.perf_counter()
        res = solve(b)
        sync()
        t1 = time.perf_counter()
        unconverged += int(not res.converged)
        if in_window:
            if trace:
                run.probe_s.append(host_probe())
            run.solve_s.append(t1 - t0)
            run.iterations.append(res.n_iterations)
            run.converged.append(bool(res.converged))
            t_close, tail = t1, (k, alpha, beta, res)
        if checked:
            raw.append((k, alpha, beta, _host(res.x), _host(precond.first),
                        res.residual_norm / res.norm0))
            precond.first = None
        k += 1
    if tail is not None and tail[0] not in loads.checked:
        # the window's last solve is checked too (its answer, not its V-cycle)
        i, alpha, beta, res = tail
        raw.append((i, alpha, beta, _host(res.x), None, res.residual_norm / res.norm0))
    del tail, res
    # the window's time leaves out the probes between its solves
    run.window_s = t_close - t_open - sum(run.probe_s[:-1])
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        run.phases = dict(recorder.seconds)
        n = int(cell.traffic["trace_solves"])
        plain = system.wrapper

        def traced_solves():
            its = 0
            for j in range(n):
                its += system.solve(system.rhs(*loads.pair(k + j)), plain).n_iterations
            return its

        run.trace = traced(traced_solves, sync)

    samples = [
        chk.Sample(i, a, bb, system.to_host(_back(x, device)),
                   None if z is None else system.to_host(_back(z, device)), claimed, i == loads.steady)
        for i, a, bb, x, z, claimed in raw
    ]
    points = system.points()
    degree = params.fe_degree_fine
    del system, precond, recorder, raw
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = chk.Referee(cell.config["reference"], cell.traffic["mesh"], degree, device).read(points, samples)
    limits = {"true_residual": float(cell.config["solver"]["RelativeTolerance"])}
    limits.update(cell.limits)
    correct, table = chk.judge(readings, limits, unconverged)
    log(f"[bench] reference check {time.perf_counter() - t_ref:.1f} s on {len(samples)} solves "
        f"(window indices {[s.index for s in samples]})")

    metrics = {}
    for m in cell.metrics(trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "count": 1,
           "memory_peak_bytes": int(run.peak_bytes)}
    if cuda:
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["card"] = card_line()
    result = {
        "correct": bool(correct),
        "attempted": k,
        "failed": unconverged,
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        result["device"].update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["solves_in_window"] = len(run.solve_s)
    # for the record (no metric reads them): the set-up split and every solve
    result["setup_split"] = split
    result["solve_s"] = run.solve_s
    result["iterations"] = run.iterations
    result["limits"] = table
    return result


def _host(v):
    """A host copy of a solve's slot vector (a twofloat pair stays a pair)."""
    if hasattr(v, "hi"):
        return type(v)(v.hi.cpu(), v.lo.cpu())
    return v.cpu()


def _back(v, device):
    if hasattr(v, "hi"):
        return type(v)(v.hi.to(device), v.lo.to(device))
    return v.to(device)
