"""The AMG coarse solve per CG iteration (ms): its three phases
(``amg_smooth``, ``amg_transfer``, ``amg_dense``, at every AMG level) from
the port's PhaseRecorder on the window's solves.  They run inside the
phase ``cs``, whose recorded time leaves them out.  None where the program
records no AMG phase."""

AMG = ("amg_smooth", "amg_transfer", "amg_dense")


def read(run):
    if not run.phases or not all(k in run.phases for k in AMG):
        return None
    return run.phase_ms_per_it(AMG)
