"""Every cell's files parse and are found by name; BENCHMARK.json keeps the
shape its format requires; the frozen roofline arithmetic gives
the least times recorded in PERF.md."""

import importlib.util
import json
import os
import re

import pytest

from harness import bench, traffic
from harness.roofline import least_ms

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry_and_reader(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    e2e = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source", "workloads"}
    keys |= {"bound"} if e2e else {"layer", "moves"}
    assert set(metric) <= keys
    if e2e:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    path = os.path.join(bench.HERE, "metrics", f"{metric['name']}.py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    assert mod.read(bench.Run(n_dofs=1)) is None or metric["name"] == "setup_s"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = bench.Cell.find(name)
    assert cell.workload["chips"] == 1
    p = cell.params()
    assert p.type == cell.config["solver"]["Type"]
    assert p.n_ref_global == cell.traffic["mesh"]["NRefGlobal"]
    assert cell.config_entry["file"].startswith("bench_h100/configs/")
    assert set(cell.limits) == {"first_step_residual", "residual_gap"}
    reported = {m["name"] for m in cell.metrics(False)}
    assert {"setup_s", "dof_solves_per_s", "solve_ms_p90", "peak_mem_gib"} <= reported
    layer = {m["name"] for m in cell.metrics(True)}
    assert ("ls_interface.ms_per_it" in layer) == (p.type == "HMG-local")
    loads = traffic.Loads(cell.traffic, 2**31 + 77)
    a, b = loads.pair(0)
    assert 0.5 <= a <= 1.5 and -1.0 <= b <= 1.0
    n = cell.traffic["check"]["solves"]
    assert loads.steady in loads.checked and n <= len(loads.checked) <= n + 1
    assert max(loads.checked) < cell.traffic["check"]["within"]


def test_loads_repeat_per_seed_and_cover_the_ranges():
    t = traffic.load(os.path.join(bench.HERE, "traffic", "quadrant_r7.json"))
    one, two = traffic.Loads(t, 5 * 10**9), traffic.Loads(t, 5 * 10**9)
    assert [one.pair(k) for k in range(20)] == [two.pair(k) for k in range(20)]
    assert one.checked == two.checked
    other = traffic.Loads(t, -3)
    assert [other.pair(k) for k in range(5)] != [one.pair(k) for k in range(5)]
    alphas = sorted(one.pair(k)[0] for k in range(40))
    # an even cover: every tenth of the range holds a few of 40 solves
    counts = [sum(0.5 + 0.1 * i <= a < 0.6 + 0.1 * i for a in alphas) for i in range(10)]
    assert min(counts) >= 2


@pytest.mark.parametrize("dtype,us", [("float32", 43.94), ("float64", 87.89)])
def test_frozen_bound_at_the_finest_patch_shape(dtype, us):
    ms, by = least_ms(512, 33, dtype)
    assert by == "bytes" and round(1e3 * ms, 2) == us
