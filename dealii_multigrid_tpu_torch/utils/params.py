"""Run configuration: JSON parameter files with the reference's exact key set.

Mirrors RunParameters::parse + MultigridParameters (reference:
multigrid_throughput.cc:297-334, 1970-2015), including the integer
``Partitioner`` 0-7 aliases for policy names
(multigrid_throughput.cc:2076-2104).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class CoarseSolverParameters:
    type: str = "amg"
    maxiter: int = 10000
    abstol: float = 1e-20
    reltol: float = 1e-4
    smoother_sweeps: int = 1
    n_cycles: int = 1
    smoother_type: str = "ILU"


@dataclass
class SmootherParameters:
    type: str = "chebyshev"
    smoothing_range: float = 20.0
    degree: int = 5
    eig_cg_n_iterations: int = 20


@dataclass
class SolverControlParameters:
    maxiter: int = 10000
    abstol: float = 1e-20
    reltol: float = 1e-4


@dataclass
class MultigridParameters:
    coarse_solver: CoarseSolverParameters = field(default_factory=CoarseSolverParameters)
    smoother: SmootherParameters = field(default_factory=SmootherParameters)
    cg_normal: SolverControlParameters = field(default_factory=SolverControlParameters)
    cg_parameter_study: SolverControlParameters = field(
        default_factory=lambda: SolverControlParameters(20, 1e-40, 1e-40)
    )
    do_parameter_study: bool = False
    n_repetitions: int = 5


# integer Partitioner key -> policy name (multigrid_throughput.cc:2076-2104)
_PARTITIONER_ALIASES = {
    0: "",
    1: "DefaultPolicy",
    2: "BalancedGranularityPartitionPolicy",
    3: "MinimalGranularityPolicy-10",
    4: "CellWeightPolicy-1.5",
    5: "CellWeightPolicy-2.0",
    6: "CellWeightPolicy-2.5",
    7: "FirstChildPolicy",
}


@dataclass
class RunParameters:
    type: str = "PMG"
    geometry_type: str = "quadrant_flexible"
    n_ref_global: int = 6
    n_ref_local: int = 0
    fe_degree_fine: int = 4
    paraview: bool = False
    verbose: bool = True
    partitioner: int = 0
    policy_name: str = ""
    mg_number_type: str = "float"
    simulation_type: str = "Constant"
    min_level: int = -1
    min_n_cells: int = -1
    dim: int = 3
    profile_phases: bool = False  # per-phase MG timing table (extra compiles)
    # outer solve Number (reference: run<3,1,double,*>); values: double |
    # float | mixed (f64 vectors around the f32 operator) | df32 (TPU-native
    # double-single f32x2 vectors, solvers/twofloat.py — no device f64)
    number_type: str = "double"
    # TPU extension: shard the solve over this many devices (the mpirun -np N
    # analog); 0 = all available devices, 1 = single device
    n_shards: int = 1
    mg_data: MultigridParameters = field(default_factory=MultigridParameters)

    def effective_policy_name(self) -> str:
        if self.policy_name:
            return self.policy_name
        return _PARTITIONER_ALIASES.get(self.partitioner, "")

    @classmethod
    def parse(cls, file_name: str) -> "RunParameters":
        with open(file_name) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "RunParameters":
        p = cls()
        get = raw.get

        def as_int(v, d):
            return d if v is None else int(v)

        def as_float(v, d):
            return d if v is None else float(v)

        def as_bool(v, d):
            if v is None:
                return d
            if isinstance(v, str):
                return v.lower() in ("true", "1", "yes")
            return bool(v)

        p.type = get("Type", p.type)
        p.geometry_type = get("GeometryType", p.geometry_type)
        p.n_ref_global = as_int(get("NRefGlobal"), p.n_ref_global)
        p.n_ref_local = as_int(get("NRefLocal"), p.n_ref_local)
        p.fe_degree_fine = as_int(get("Degree"), p.fe_degree_fine)
        p.paraview = as_bool(get("Paraview"), p.paraview)
        p.verbose = as_bool(get("Verbosity"), p.verbose)
        p.partitioner = as_int(get("Partitioner"), p.partitioner)
        p.policy_name = get("PartitionerName", p.policy_name)
        p.min_level = as_int(get("MinLevel"), p.min_level)
        p.min_n_cells = as_int(get("MinNCells"), p.min_n_cells)
        p.mg_data.coarse_solver.type = get(
            "CoarseGridSolverType", p.mg_data.coarse_solver.type
        )
        p.mg_data.smoother.degree = as_int(
            get("SmootherDegree"), p.mg_data.smoother.degree
        )
        p.mg_data.coarse_solver.n_cycles = as_int(
            get("CoarseSolverNCycles"), p.mg_data.coarse_solver.n_cycles
        )
        p.mg_data.cg_normal.reltol = as_float(
            get("RelativeTolerance"), p.mg_data.cg_normal.reltol
        )
        p.mg_number_type = get("MGNumberType", p.mg_number_type)
        p.simulation_type = get("SimulationType", p.simulation_type)
        # extensions beyond the reference key set (TPU build)
        p.dim = as_int(get("Dim"), p.dim)
        p.number_type = get("NumberType", p.number_type)
        p.n_shards = as_int(get("NShards"), p.n_shards)
        if "DoParameterStudy" in raw:
            p.mg_data.do_parameter_study = as_bool(get("DoParameterStudy"), False)
        if "NRepetitions" in raw:
            p.mg_data.n_repetitions = as_int(get("NRepetitions"), 5)
        p.profile_phases = as_bool(get("ProfilePhases"), False)
        return p
