"""Median ms, over the window's chunks, of integration
(``BlockPipeline.integrate``, and the color's when it runs): from mark
``alloc`` to ``integrate``, in the captured step's last replay of each
chunk (events on the card; the window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    return records.median(records.graph_ms(run, "step", "alloc", "integrate"))
