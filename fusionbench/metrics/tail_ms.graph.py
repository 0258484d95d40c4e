"""Median ms, over the window's chunks, of the SLAM chunk's tail graph
(``models/slam.CapturedSlam``, function ``tail``: the keyframe inserts,
loop detection with the eig6 kernel, the ring's writes, the packing of
the fetch), from its ``start`` mark to its ``end`` mark (events on the
card; the window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    return records.median(records.graph_ms(run, "tail", "start", "end"))
