"""All recorded V-cycle phases per CG iteration (ms), from the port's
PhaseRecorder on the window's solves."""


def read(run):
    return run.phase_ms_per_it()
