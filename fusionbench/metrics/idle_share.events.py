"""Percent of the window's seconds in which no chunk's device work ran:
100 x (1 - the summed device spans of the window's chunks over the
seconds the harness's spans cover in the window).  A chunk's span runs
from an event before its first depth copy to one after its last aux copy
(``CapturedStep.run``, record ``chunk``), so the fetch and the host's
time between chunks are what is idle; timed by events, not the profiler
(the window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    w = records.window(run)
    ms = [r.value for r in (w[0] if w else []) if r.kind == "device" and r.name == "chunk"]
    return 100.0 * (1.0 - sum(ms) / 1000.0 / w[1]) if ms else None
