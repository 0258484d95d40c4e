"""The port's Python launch counts, and its trace records, in one registry.

Launch counts.  A wrapper that launches device work counts its launches
in attributes of an object (``integrate_blocks_cuda.launches``,
``MapAxis.calls``) and registers those attributes here.  A CUDA graph
replays the launches without running the wrappers' Python, so
``models/captured.Graph`` reads every registered count around its
capture and adds what the capture counted on each replay: a count
registered here stays the number of launches that ran, captured or not.

Records.  Three kinds go into one bounded ring in memory (``records()``;
``dropped()`` counts what a full ring or an empty event pool lost, and
``dropped(t0, t1)`` those made in a stretch of host time),
each with its name, its id, the id of the span that was open when it was
made, the id of the chunk it belongs to (a span opened with no span open
starts a chunk; the records made inside it share its chunk) and host
times from ``time.perf_counter_ns``:

- ``span(name)``: a host span, start and end.  While a ``torch.profiler``
  session records, it is also a range ``tf:<name>`` on the host's
  timeline, in an operator's scope: the profiler mirrors a user
  annotation (``record_function``) on the device's timeline as if it were
  device work, and an operator's scope it does not.
- ``mark(stage)`` inside a graph's capture (``models/captured.Graph``
  installs a ``Marks`` for each, with a ``start`` and an ``end`` mark
  around it): a timing event that every replay records on the card.  A
  ``stages`` record gives each mark's ms since ``start`` in the last
  replay before the records are next read (``flush``), stamped with the
  host times of that replay's enqueue; so one sample per chunk.  On the
  CPU an eager step's marks are host stamps.
- ``DeviceSpans(name, device).span()``: a stretch of enqueued device work
  between two timing events from a small pool (host stamps on the CPU);
  a ``device`` record gives its ms.

Events are read once complete (``Event.query``), never by a sync of the
registry's own: ``flush`` keeps what has completed and leaves the rest
pending.  ``enable(False)`` stops every record; call it before a
capture for graphs without marks.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
import weakref
from typing import Any, NamedTuple, Optional

import torch

# owner -> (label, attribute names); an owner that is collected leaves.
_OWNERS = weakref.WeakKeyDictionary()


def register(owner, label: str, *attrs: str) -> None:
    """Make ``owner``'s integer attributes ``attrs`` registered counts,
    named ``label.attr``."""
    _OWNERS[owner] = (label, attrs)


def read() -> dict:
    """(owner, attribute) -> value of every registered count."""
    return {(o, a): getattr(o, a) for o, (_, attrs) in list(_OWNERS.items()) for a in attrs}


def name(owner, attr: str) -> str:
    return f"{_OWNERS[owner][0]}.{attr}"


# ---------------------------------------------------------------- records
RING = 1 << 16


class Record(NamedTuple):
    kind: str               # "span", "stages" or "device"
    name: str               # the span's; the captured function's; the DeviceSpans'
    id: int
    parent: Optional[int]   # the span open when it was made
    chunk: int
    t0: int                 # host ns: the span's start, or the enqueue's
    t1: int                 # its end
    value: Any              # stages: ((mark, ms since start), ...); device: ms


_on = True
_dropped = 0
_drops = collections.deque(maxlen=RING)    # host ns of each lost record
_ring = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_chunks = itertools.count(1)
_open = []          # (id, chunk) of the open spans, innermost last
_pending = []       # what waits for its events to complete: each has poll()
_marks = None       # the Marks that mark() writes into


def enable(on: bool = True) -> None:
    """Turn the records on or off (on by default)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def dropped(t0: Optional[int] = None, t1: Optional[int] = None) -> int:
    """The records lost; with host ns ``t0`` and ``t1``, those that
    started between them."""
    if t0 is None:
        return _dropped
    return sum(t0 <= t <= t1 for t in _drops)


def _drop(t: int) -> None:
    global _dropped
    _dropped += 1
    _drops.append(t)


def _keep(kind, name, id, parent, chunk, t0, t1, value) -> None:
    if len(_ring) == _ring.maxlen:
        _drop(_ring[0].t0)
    _ring.append(Record(kind, name, id, parent, chunk, t0, t1, value))


def _context():
    """(parent, chunk) of a record made now."""
    return _open[-1] if _open else (None, next(_chunks))


def flush() -> None:
    """Keep the records whose events have completed."""
    _pending[:] = [p for p in _pending if not p.poll()]


def records() -> list:
    """Every record in the ring, oldest first (after a ``flush``)."""
    flush()
    return list(_ring)


class _Span:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.live = _on
        if self.live:
            self.parent, self.chunk = _context()
            self.id = next(_ids)
            _open.append((self.id, self.chunk))
            self.rf = None
            if torch._C._autograd._profiler_enabled():
                self.rf = torch._C._profiler._RecordFunctionFast("tf:" + self.name)
                self.rf.__enter__()
            self.t0 = time.perf_counter_ns()
            self.started()
        return self

    def __exit__(self, *exc):
        if self.live:
            self.ended()
            self.t1 = time.perf_counter_ns()
            _open.pop()
            if self.rf is not None:
                self.rf.__exit__(*exc)
            self.finish()
        return False

    def started(self) -> None:
        pass

    def ended(self) -> None:
        pass

    def finish(self) -> None:
        _keep("span", self.name, self.id, self.parent, self.chunk, self.t0, self.t1, None)


def span(name: str) -> _Span:
    """A host span around a ``with`` block."""
    return _Span(name)


class DeviceSpans:
    """Spans of the device work enqueued inside a ``with span()`` block,
    each between two timing events of a pool of ``size`` pairs, read once
    the second completes; a span that finds the pool empty is dropped.  On
    a device other than the card the span is the host's time."""

    def __init__(self, name: str, device, size: int = 4):
        self.name = name
        self.cuda = torch.device(device).type == "cuda"
        self.free = ([(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(size)] if self.cuda else [])

    def span(self) -> "_DeviceSpan":
        return _DeviceSpan(self)


class _DeviceSpan(_Span):
    def __init__(self, spans: DeviceSpans):
        super().__init__(spans.name)
        self.spans = spans

    def started(self) -> None:
        self.ev = None
        if self.spans.cuda and self.spans.free:
            self.ev = self.spans.free.pop()
            self.ev[0].record()

    def ended(self) -> None:
        if self.ev is not None:
            self.ev[1].record()

    def finish(self) -> None:
        if not self.spans.cuda:
            self._keep((self.t1 - self.t0) / 1e6)
        elif self.ev is None:
            _drop(self.t0)
        else:
            _pending.append(self)

    def _keep(self, ms: float) -> None:
        _keep("device", self.name, self.id, self.parent, self.chunk, self.t0, self.t1, ms)

    def poll(self) -> bool:
        a, b = self.ev
        if not b.query():
            return False
        self._keep(a.elapsed_time(b))
        self.spans.free.append(self.ev)
        return True


class Marks:
    """The stage marks of one graph, named after its captured function:
    on the card a timing event per ``mark`` of the capture, which each
    replay records; on the CPU the host's stamps of the last eager call.
    ``replayed`` after each replay (or call) makes it the one read."""

    def __init__(self, name: str, cuda: bool):
        self.name, self.cuda = name, cuda
        self.marks = []     # (stage, event or host ns)
        self.want = None    # (parent, chunk, t0, t1) of the replay to read

    def add(self, stage: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
        else:
            ev = time.perf_counter_ns()
        self.marks.append((stage, ev))

    def replayed(self, t0: int, t1: int) -> None:
        """The replay enqueued from host ns ``t0`` to ``t1`` is the one to read."""
        if not _on:
            return
        if self.want is None:
            _pending.append(self)
        self.want = (*_context(), t0, t1)

    def poll(self) -> bool:
        if self.cuda and not self.marks[-1][1].query():
            return False
        first = self.marks[0][1]
        if self.cuda:
            stages = tuple((s, first.elapsed_time(e)) for s, e in self.marks)
        else:
            stages = tuple((s, (e - first) / 1e6) for s, e in self.marks)
        _keep("stages", self.name, next(_ids), *self.want, stages)
        self.want = None
        return True


@contextlib.contextmanager
def recording(marks: Optional[Marks]):
    """``mark`` writes into ``marks`` inside the block, between a
    ``start`` and an ``end`` mark (nothing when ``marks`` is None)."""
    global _marks
    if marks is None:
        yield
        return
    marks.marks = []
    prev, _marks = _marks, marks
    try:
        mark("start")
        yield
        mark("end")
    finally:
        _marks = prev


def mark(stage: str) -> None:
    """The end of ``stage`` in the graph being captured (or the eager
    step being recorded); nothing otherwise."""
    if _marks is not None:
        _marks.add(stage)
