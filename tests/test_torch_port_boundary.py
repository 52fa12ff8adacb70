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


def _lap1d(n: int = 50):
    import scipy.sparse as sp

    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n)).tocsr()


@pytest.mark.parametrize("builder", ["build_amg", "build_stokes_nsinker", "make_stokes_rebuilder",
                                     "build_convection_demo"])
def test_builders_without_device_need_the_card(builder):
    """No device means the card: without one the builder raises, and it
    never builds on the host behind the caller's back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dealii_multigrid_tpu_torch.mantle_convection import demo
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.models import nsinker
    from dealii_multigrid_tpu_torch.solvers import amg
    from dealii_multigrid_tpu_torch.utils.params import MultigridParameters

    mesh = generators.create("hypercube", 3, 1, 0)
    calls = {
        "build_amg": lambda: amg.build_amg(_lap1d()),
        "build_stokes_nsinker": lambda: nsinker.build_stokes_nsinker(
            mesh, MultigridParameters(), nsinker.nsinker_viscosity()),
        "make_stokes_rebuilder": lambda: nsinker.make_stokes_rebuilder(mesh, MultigridParameters()),
        "build_convection_demo": lambda: demo.build_convection_demo(1),
    }
    with pytest.raises(RuntimeError, match="does not fall back"):
        calls[builder]()
