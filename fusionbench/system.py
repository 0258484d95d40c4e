"""What the harness shares between drivers: the configuration built from
its file (for the port and for the reference alike), host snapshots of
device state, the clock, and the record of spans the harness keeps."""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch


def build_config(config_module, pipeline: dict):
    """``config_module.PipelineConfig`` with every field from the file's
    ``pipeline`` object (lists become tuples), so the port's defaults can
    not move the yardstick."""
    PC = config_module.PipelineConfig
    default = PC()
    kw = {}
    for f in dataclasses.fields(PC):
        if f.name not in pipeline:
            raise KeyError(f"the configuration file lacks pipeline.{f.name}")
        v = pipeline[f.name]
        if isinstance(v, dict):
            sub = type(getattr(default, f.name))
            v = sub(**{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()})
        kw[f.name] = v
    return PC(**kw)


def leaves(x) -> list:
    """The tensors of a (nested) NamedTuple or tuple, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def rebuild(template, ts: list):
    """``template``'s structure (NamedTuples and tuples, of any module)
    with its tensors taken from ``ts`` in order."""
    it = iter(ts)

    def go(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[go(v) for v in x])
        if isinstance(x, tuple):
            return tuple(go(v) for v in x)
        return x

    return go(template)


class HostSnapshot:
    """Host copies of a state's tensors (pinned where the state is on
    the card), allocated in the set-up (``like``) and filled without a
    host sync (``take`` queues the copies on the current stream)."""

    def __init__(self, template, tensors):
        self.template = template
        self.tensors = tensors

    @classmethod
    def like(cls, state) -> "HostSnapshot":
        return cls(state, [torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                           for t in leaves(state)])

    def take(self, state) -> "HostSnapshot":
        self.template = state
        for h, t in zip(self.tensors, leaves(state)):
            h.copy_(t, non_blocking=t.is_cuda)
        return self

    def to(self, device):
        """The state back on ``device`` (as the program's types)."""
        return rebuild(self.template, [t.to(device) for t in self.tensors])


class Spans:
    """Host spans the harness records around its calls into the program
    (name, start, end in ``time.perf_counter`` seconds), kept in memory;
    under the profiler each is also a ``record_function`` range."""

    def __init__(self):
        self.spans = []
        self.profiling = False

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name, self.rf = owner, name, None

    def __enter__(self):
        if self.owner.profiling:
            self.rf = torch.profiler.record_function("fb:" + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.owner.spans.append((self.name, self.t0, time.perf_counter()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def fresh_peak(device) -> None:
    """Forget the memory peak so far (the traffic's rendering): the peak
    read after the window is the program's, with the frames it is fed."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cut(NamedTuple):
    """A chunk the comparison checks: its index in the window, the
    frames' indices in the pass, and the program's state before it (on
    the host)."""
    index: int
    frames: list
    pre: HostSnapshot
