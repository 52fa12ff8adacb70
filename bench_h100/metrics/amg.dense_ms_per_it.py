"""The AMG's dense coarsest solve per CG iteration (ms): the phase
``amg_dense`` (two triangular solves with the Cholesky factor) from the
port's PhaseRecorder.  None where the program records no such phase."""


def read(run):
    if not run.phases or "amg_dense" not in run.phases:
        return None
    return run.phase_ms_per_it(("amg_dense",))
