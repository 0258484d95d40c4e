"""Median host time (ms) from a chunk's hand-off to
``SlamSystem.process_chunk`` to its results on the host, over the
window's chunks."""

import statistics


def read(run):
    return statistics.median(run.chunk_s) * 1000.0 if run.chunk_s else None
