"""Mean device time (ms, CUDA events) of the pose-graph solves the
window ran (``SlamSystem._solve``); nothing when no loop closed."""


def read(run):
    return sum(run.solve_ms) / len(run.solve_ms) if run.solve_ms else None
