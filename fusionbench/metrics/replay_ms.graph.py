"""Median ms, over the window's chunks, of the captured step's last
replay in each chunk, from the graph's ``start`` mark to its ``end`` mark
(``models/captured.Graph``, events on the card): the whole replay, with
the state's copy-back and the gaps between the graph's nodes.

The window rule of every reader of the program's trace records
(``topfusion_tpu_torch.utils.counters.records``) lives here.  The
window's chunks are its harness spans, the last ``notes["chunks"]``
spans named ``run`` (the captured step) or ``process_chunk`` (the SLAM
system).  A traced run profiles a slice half way through the window,
and the profiler slows the chunks after it, so only the chunks before
the slice count: the captured step's
that end within ``run.seconds / 2`` of the first one's start (its driver
starts the slice after the chunk that crosses that point), the SLAM
system's first ``chunks // 2`` (its driver starts the slice at that
chunk).  The records are those from the start of the first of these
chunks to the start of the window's next chunk, so that the last one's
fetch is in; the seconds those the harness's spans cover there.  A program without the records, a stretch without any, or one in
which the program lost a record (``counters.dropped``) reads None."""

import statistics

SPAN = {"captured_step": "run", "slam": "process_chunk"}


def _before_slice(run, chunks: list) -> list:
    if run.config.get("entry") == "slam":
        return chunks[:len(chunks) // 2]
    return [c for c in chunks if c[2] <= chunks[0][1] + run.seconds / 2]


def window(run):
    """(the window's records, its seconds), or None."""
    try:
        from topfusion_tpu_torch.utils import counters
    except ImportError:
        return None
    records = getattr(counters, "records", None)
    n = run.notes.get("chunks") or 0
    spans = [s for s in run.spans.spans if s[0] == SPAN.get(run.config.get("entry"))]
    if records is None or not n or len(spans) < n:
        return None
    chunks = spans[-n:]
    kept = _before_slice(run, chunks)
    if not kept:
        return None
    t0 = kept[0][1]
    t1 = chunks[len(kept)][1] if len(kept) < n else run.spans.spans[-1][2]
    ns = int(t0 * 1e9), int(t1 * 1e9)
    if counters.dropped(*ns):
        return None
    got = [r for r in records() if ns[0] <= r.t0 and r.t1 <= ns[1]]
    seconds = sum(b - a for _, a, b in run.spans.spans if t0 <= a and b <= t1)
    return (got, seconds) if got else None


def graph_ms(run, graph: str, a: str, b: str) -> list:
    """ms from mark ``a`` to mark ``b`` of each of the window's samples of
    the graph captured from the function ``graph``."""
    w = window(run)
    return [dict(r.value)[b] - dict(r.value)[a] for r in (w[0] if w else [])
            if r.kind == "stages" and r.name == graph]


def span_ms(run, name: str) -> list:
    """ms of each of the window's host spans ``name``."""
    w = window(run)
    return [(r.t1 - r.t0) / 1e6 for r in (w[0] if w else []) if r.kind == "span" and r.name == name]


def median(xs: list):
    return statistics.median(xs) if xs else None


def read(run):
    return median(graph_ms(run, "step", "start", "end"))
