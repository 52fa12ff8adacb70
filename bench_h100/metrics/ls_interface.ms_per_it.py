"""Local smoothing's refinement-edge operators and its copies to and from
the level vectors (phases edge_pro, to_mg, to_global) per CG iteration (ms)."""


def read(run):
    if not run.local_smoothing:
        return None
    return run.phase_ms_per_it(("edge_pro", "to_mg", "to_global"))
