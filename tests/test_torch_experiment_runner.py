"""The port's experiment runner (dealii_multigrid_tpu_torch/tools/run_experiment.py), CPU.

``small-scaling quadrant --max-ref 3`` on the CPU takes the TPU record's
iteration counts (4, 4, 4, 4; results/small-scaling-quadrant-tpu-merged.txt)
and leaves an artifact whose first line names the device, the commit and
the date and whose rows end with a ``device`` column; sharded configs
(NShards 2) run over two gloo ranks with the record's counts; without a
card the default device raises.  The record comparison reads a results table by its
header's column offsets (an empty identity cell is not compared).
"""

import os

import pytest
import torch

from dealii_multigrid_tpu_torch.tools import run_experiment as rx

RECORD = os.path.join(rx.REPO, "results", "small-scaling-quadrant-tpu-merged.txt")


def test_small_scaling_r3_equals_the_tpu_record(tmp_path):
    out = tmp_path / "ss.txt"
    sweep = rx.run_experiment("small-scaling", ["quadrant"], "cpu", str(out), max_ref=3,
                              against=[RECORD], commit="abc123")
    assert [int(r["n_iterations"]) for r in sweep.rows] == [4, 4, 4, 4]
    assert len(sweep.ran) == 4 and not sweep.failed and len(sweep.skipped_ref) == 64
    assert sweep.count("equal") == 4 and sweep.count("differs") == 0
    text = out.read_text().splitlines()
    assert text[0].startswith("# device: cpu | commit: abc123 | date: ")
    rows = rx.parse_tables("\n".join(text))
    assert len(rows) == 4 and all(r["device"] == "cpu" for r in rows)
    assert list(rows[0])[-1] == "device"
    assert any(ln.startswith("# SKIPPED (--max-ref 3): input_0004.json") for ln in text)
    assert text[-1].endswith("4 equal, 0 differs, 0 ambiguous, 0 none")


def test_degree_filter_and_repetitions(tmp_path, capsys, monkeypatch):
    """``--degree 4`` (chip_smoke.py phase y cuts the partitioning sweep so)
    runs only the p=4 configs: at r=3 the two p=4 rows, with the record's
    counts; the p=1 configs land on a SKIPPED line.  ``--repetitions 1``
    reaches every config that runs."""
    seen = []
    run_config = rx.run_config

    def spy(params, table, device):
        seen.append(params.mg_data.n_repetitions)
        return run_config(params, table, device)

    monkeypatch.setattr(rx, "run_config", spy)
    out = tmp_path / "ss.txt"
    rc = rx.main(["small-scaling", "quadrant", "--max-ref", "3", "--degree", "4", "--repetitions",
                  "1", "--device", "cpu", "--against", RECORD, "--out", str(out)])
    assert rc == 0 and seen == [1, 1]
    rows = rx.parse_tables(out.read_text())
    assert [(r["degree"], int(r["n_iterations"])) for r in rows] == [("4", 4), ("4", 4)]
    text = out.read_text().splitlines()
    assert any(ln.startswith("# SKIPPED (--degree 4): input_0000.json, input_0001.json")
               for ln in text)
    assert "2 ran, 0 failed, 64 skipped by --max-ref, 2 by --degree" in capsys.readouterr().out


def test_sharded_configs_run_with_record_counts(tmp_path, capsys):
    """``large_scaling quadrant 2`` (NShards 2, once NotImplementedError)
    runs its four r=4 rows over two gloo ranks each, with the r=4 counts of
    results/large-scaling-partitioning-virtual8.txt for the same type and
    degree."""
    out = tmp_path / "ls.txt"
    rc = rx.main(["large_scaling", "quadrant", "2", "--max-ref", "4", "--device", "cpu",
                  "--out", str(out)])
    assert rc == 0
    rows = rx.parse_tables(out.read_text())
    assert not [ln for ln in out.read_text().splitlines() if ln.startswith("# FAILED ")]
    want = {("HMG-local", "1"): 5, ("HMG-global", "1"): 4, ("HMG-local", "4"): 4,
            ("HMG-global", "4"): 3}
    assert len(rows) == 4
    assert {(r["type"], r["degree"]): int(r["n_iterations"]) for r in rows} == want
    assert "4 ran, 0 failed" in capsys.readouterr().out


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        rx.main(["small-scaling", "quadrant", "--max-ref", "3", "--device", "cuda",
                 "--out", str(tmp_path / "x.txt")])
    assert not (tmp_path / "x.txt").exists()


def test_compare_rows_verdicts():
    rec = rx.parse_tables(
        "# a record\n"
        "dim type       degree n_ref_global n_iterations coarse_type\n"
        "3   HMG-global 4      3            4            amg\n"
        "3   HMG-local  4      3            5\n"
        "3   HPMG       4      5            4            amg\n"
        "3   HPMG       4      5            8            amg_petsc\n"
        "3   PMG        4      5            4\n"
        "3   PMG        4      5            6\n"
    )
    assert rec[1]["coarse_type"] == ""  # an empty cell stays empty

    def row(t, r, n, coarse="amg"):
        return {"type": t, "degree": 4, "n_ref_global": r, "n_iterations": n,
                "coarse_type": coarse}

    got = [v for v, _ in rx.compare_rows(
        [row("HMG-global", 3, 4), row("HMG-local", 3, 4), row("HPMG", 5, 8, "amg_petsc"),
         row("PMG", 5, 6), row("PMG", 5, 7), row("HMG-global", 4, 3)], rec)]
    assert got == ["equal", "differs", "equal", "ambiguous", "differs", "none"]


def test_every_tpu_record_parses():
    for name in sorted(os.listdir(os.path.join(rx.REPO, "results"))):
        if "-tpu" in name and name.endswith(".txt") and "stokes" not in name:
            rows = rx.parse_tables(open(os.path.join(rx.REPO, "results", name)).read())
            assert rows and all(r["n_iterations"].isdigit() for r in rows), name


def jax_counts(experiment: str, gen_args: list, max_ref: int = 5) -> None:
    """Every config of a sweep generator at NRefGlobal <= ``max_ref`` through
    the JAX package and the port on the CPU, with both iteration counts: the
    check, where a runner row differs from its TPU record, of whether the
    count is the algorithm's.  Run as ``PYTHONPATH=. python
    tests/test_torch_experiment_runner.py parameters_mgnumber 4`` (minutes)."""
    import glob
    import subprocess
    import sys
    import tempfile

    import jax

    from dealii_multigrid_tpu import api as japi
    from dealii_multigrid_tpu.utils.params import RunParameters as JParams
    from dealii_multigrid_tpu_torch import api as tapi
    from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams

    jax.config.update("jax_enable_x64", True)
    gen = rx.find_generator(experiment)
    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ, PYTHONPATH=rx.SCRIPTS)
        subprocess.run([sys.executable, gen, *gen_args], cwd=work, env=env, check=True)
        for path in sorted(glob.glob(os.path.join(work, "input_*.json"))):
            tp = TParams.parse(path)
            if tp.n_ref_global > max_ref:
                continue
            jres, _, _ = japi.run(JParams.parse(path))
            tres, _, _ = tapi.run(tp, "cpu")
            print(f"{os.path.basename(path)} {tp.type} r={tp.n_ref_global} p={tp.fe_degree_fine} "
                  f"mg={tp.mg_number_type} smoother degree {tp.mg_data.smoother.degree}: JAX package "
                  f"{jres.n_iterations}, port {tres.n_iterations}", flush=True)


if __name__ == "__main__":
    import sys

    jax_counts(sys.argv[1], sys.argv[2:])
