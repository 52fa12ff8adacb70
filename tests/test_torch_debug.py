"""Debug mode of the port (``MGTPU_DEBUG``), as tests/test_hybrid.py checks
the JAX package's: the variable turns the slot-layout verification of every
hybrid level build on and off, a broken layout raises naming its invariant,
a debug-mode solve equals the plain one, and a NaN inside a V-cycle raises
FloatingPointError naming the phase where it appeared.
"""

import dataclasses

import numpy as np
import scipy.sparse as sp
import pytest
import torch

from dealii_multigrid_tpu_torch import api
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.models import stokes as TS
from dealii_multigrid_tpu_torch.ops import hybrid_format as HF
from dealii_multigrid_tpu_torch.solvers import multigrid
from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG
from dealii_multigrid_tpu_torch.utils import phases
from dealii_multigrid_tpu_torch.utils.params import MultigridParameters, RunParameters

from test_torch_hp_solve import params


def test_variable_switches_format_verification(monkeypatch):
    calls = []
    verify = HF.verify_format
    monkeypatch.setattr(api, "verify_format", lambda fmt: calls.append(verify(fmt)))
    mesh = TG.create("quadrant", 3, 3)
    monkeypatch.setenv("MGTPU_DEBUG", "1")
    assert phases.sanitizer_enabled()
    lv = api.build_level_hybrid(mesh, 2, "cpu", torch.float32)
    assert len(calls) == 1
    monkeypatch.setenv("MGTPU_DEBUG", "0")
    assert not phases.sanitizer_enabled()
    api.build_level_hybrid(mesh, 2, "cpu", torch.float32)
    monkeypatch.delenv("MGTPU_DEBUG")
    assert not phases.sanitizer_enabled()
    api.build_level_hybrid(mesh, 2, "cpu", torch.float32)
    assert len(calls) == 1
    HF.verify_format(lv.fmt)


def test_broken_layouts_raise():
    fmt = api.build_level_hybrid(TG.create("quadrant", 3, 3), 2, "cpu", torch.float32).fmt
    with pytest.raises(AssertionError, match="owner mask"):
        HF.verify_format(dataclasses.replace(fmt, owner=np.zeros_like(fmt.owner)))
    rep = fmt.rep_slot.copy()
    rep[[0, 1]] = rep[[1, 0]]
    with pytest.raises(AssertionError, match="round-trip"):
        HF.verify_format(dataclasses.replace(fmt, rep_slot=rep))
    bad = fmt.slot_dof.copy()
    bad[-1] = fmt.dofh.n_dofs + 1
    with pytest.raises(AssertionError, match="out of range"):
        HF.verify_format(dataclasses.replace(fmt, slot_dof=bad))


@pytest.mark.parametrize("mg_type", ["HMG-global", "HMG-local"])
def test_debug_solve_equals_plain_and_nan_names_its_phase(monkeypatch, mg_type):
    prm = params(RunParameters, 3, 2, mg_type=mg_type)
    plain, _, _ = api.run(prm, "cpu")
    monkeypatch.setenv("MGTPU_DEBUG", "1")
    res, _, levels = api.run(prm, "cpu")
    assert res.solve_iterations == plain.solve_iterations
    assert torch.equal(res.x, plain.x)
    # one NaN in a smoother's diagonal: the first pre-smoothing through it
    # yields a non-finite vector
    fine = levels[-1]
    if mg_type == "HMG-global":
        mg = res.mg
        sm = mg.smoothers[-2]
        inv_diag = sm.inv_diag.clone()
        inv_diag[0] = float("nan")
        smoothers = mg.smoothers[:-2] + (dataclasses.replace(sm, inv_diag=inv_diag), mg.smoothers[-1])
        precond = PreconditionMG(dataclasses.replace(mg, smoothers=smoothers), torch.float64)
    else:
        ls = res.ls_mg
        sm = ls.smoothers[-1]
        bad = dataclasses.replace(sm, inv_diag=torch.full_like(sm.inv_diag, float("nan")))
        precond = api.PreconditionLS(dataclasses.replace(ls, smoothers=ls.smoothers[:-1] + (bad,)),
                                     fine.op.constrained_keep, torch.float64)
    with pytest.raises(FloatingPointError, match="'pre'"):
        api.mg_solve(fine.op, res.rhs_used, precond, prm.mg_data, n_levels=res.n_levels,
                     n_dofs=res.n_dofs)
    # off: no phase is checked; the NaN runs through to the residual guard
    monkeypatch.delenv("MGTPU_DEBUG")
    with pytest.raises(RuntimeError, match="loop nan"):
        api.mg_solve(fine.op, res.rhs_used, precond, prm.mg_data, n_levels=res.n_levels,
                     n_dofs=res.n_dofs)


def test_stokes_velocity_cycles_are_checked(monkeypatch):
    mg = MultigridParameters()
    mg.smoother.degree = 3
    mesh = TG.create("hypercube", 3, 1, 0)
    _, block, _ = TS.build_stokes(mesh, mg, device="cpu")
    assert block.v_precond.hook is multigrid.untimed
    monkeypatch.setenv("MGTPU_DEBUG", "1")
    op, block, _ = TS.build_stokes(mesh, mg, device="cpu")
    assert block.v_precond.hook is multigrid.finite_check
    assert block.v_precond.mg.hook is multigrid.finite_check
    r = torch.ones(3 * op.n_v + op.n_p, dtype=torch.float64)
    assert bool(torch.isfinite(block.vmult(r)).all())
    r[0] = float("nan")
    with pytest.raises(FloatingPointError, match="'to_mg'"):
        block.vmult(r)


def test_preconditioners_without_phases_are_checked_whole(monkeypatch):
    """AMG (as api.mg_solve gets it) and the Schur solves of the Stokes
    models have no V-cycle phases: debug mode checks their whole output."""
    from dealii_multigrid_tpu_torch.models import nsinker as TN
    from dealii_multigrid_tpu_torch.solvers.amg import build_amg
    from dealii_multigrid_tpu_torch.utils.phases import FiniteChecked, checked

    A = sp.diags([-np.ones(99), 2 * np.ones(100), -np.ones(99)], [-1, 0, 1]).tocsr()
    amg = build_amg(A, dtype=torch.float64, device="cpu")
    assert checked(amg) is amg
    mg = MultigridParameters()
    mg.smoother.degree = 3
    mg.coarse_solver.type = "amg"
    mesh = TG.create("hypercube", 3, 1, 0)
    monkeypatch.setenv("MGTPU_DEBUG", "1")
    guarded = checked(amg)
    b = torch.ones(100, dtype=torch.float64)
    assert torch.equal(guarded.vmult(b), amg.vmult(b))
    b[3] = float("nan")
    with pytest.raises(FloatingPointError, match="'amg'"):
        guarded.vmult(b)
    _, block, _ = TN.build_stokes_nsinker(mesh, mg, TN.nsinker_viscosity(n_sinkers=4, eta_max=1e4, seed=0),
                                          coarsening="galerkin", schur="wbfbt", device="cpu")
    _, mass_block, _ = TS.build_stokes(mesh, mg, device="cpu")
    for blk in (block, mass_block):
        assert isinstance(blk.p_solve, FiniteChecked)
        r = torch.zeros(3 * blk.n_v + blk.n_p, dtype=torch.float64)
        r[-1] = float("nan")
        with pytest.raises(FloatingPointError, match="input of the phase 'schur'"):
            blk.vmult(r)
    # a NaN made inside the w-BFBT solve reaches the second Kp solve, whose
    # CG would return zeros for it
    schur = block.p_solve
    dinv = schur.inner.dinv.masked_fill(schur.inner.dinv != 0, float("nan"))
    bad = dataclasses.replace(block, p_solve=dataclasses.replace(
        schur, inner=dataclasses.replace(schur.inner, dinv=dinv)))
    r = torch.ones(3 * block.n_v + block.n_p, dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="input of the phase 'kp'"):
        bad.vmult(r)
