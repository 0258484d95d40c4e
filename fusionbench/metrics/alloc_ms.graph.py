"""Median ms, over the window's chunks, of allocation and the visible set
(``ops/tsdf_block.allocate_from_depth``, ``visible_blocks``, the aged
set and its rescan select): from mark ``icp`` to ``alloc``, in the
captured step's last replay of each chunk (events on the card; the
window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    return records.median(records.graph_ms(run, "step", "icp", "alloc"))
