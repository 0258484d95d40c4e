"""Percent of the traced slice's host window in which no operation ran
on the device (1 - the union of the operations' intervals).  The
profiler's cost per kernel record is in it: a replayed step that keeps
the device busy untraced reads 20-45% idle here."""


def read(run):
    s = run.slice
    if not s or not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
