"""Median ms, over the window's chunks, of the wait for a SLAM chunk's
results (the span ``slam.fetch`` around the one blocking copy in
``SlamSystem._fetch``; the window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    return records.median(records.span_ms(run, "slam.fetch"))
