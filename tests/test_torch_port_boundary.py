"""Boundaries of the PyTorch port: no jax import, no silent CPU fallback."""

import os
import subprocess
import sys

import pytest
import torch

from dealii_multigrid_tpu_torch import api
from dealii_multigrid_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import dealii_multigrid_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert not any(k.startswith('dealii_multigrid_tpu.') or k == 'dealii_multigrid_tpu'"
        " for k in sys.modules)\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="does not fall back"):
        resolve_device("cuda")
    prm = api.RunParameters()
    prm.type = "HMG-global"
    prm.geometry_type = "quadrant"
    prm.n_ref_global = 2
    with pytest.raises(RuntimeError, match="does not fall back"):
        api.run(prm, "cuda:0")


def test_cpu_and_default_devices():
    """No device means the card: ``cuda:0`` with one, an error without."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="does not fall back"):
            resolve_device(None)


def test_chip_smoke_refuses_to_run_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
