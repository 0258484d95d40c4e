"""Mean ms of the pose-graph solve graph (``models/slam.CapturedSlam``,
function ``solve``) over the window's solves, from its ``start`` mark to
its ``end`` mark (events on the card; a mean, as ``solve_ms``; the window
rule in ``replay_ms.graph``).  Nothing when no loop closed."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    ms = records.graph_ms(run, "solve", "start", "end")
    return sum(ms) / len(ms) if ms else None
