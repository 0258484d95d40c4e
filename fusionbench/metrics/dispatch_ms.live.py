"""Median ms, over the window's chunks, of the host's enqueue of a SLAM
chunk (``SlamSystem.process_chunk``'s span ``slam.dispatch``: the depth
upload, the step replays and the tail, until the chunk's work is
enqueued; the window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    return records.median(records.span_ms(run, "slam.dispatch"))
