"""Median ms, over the window's chunks, of depth preprocessing and the
pyramid maps (``ops/depth.preprocess_depth``,
``ops/normals.build_maps_pyramid``): from the graph's ``start`` mark to
``preproc``, in the captured step's last replay of each chunk (events on
the card; the window rule in ``replay_ms.graph``)."""

from fusionbench.spec import metric_reader

records = metric_reader("replay_ms.graph")


def read(run):
    return records.median(records.graph_ms(run, "step", "start", "preproc"))
