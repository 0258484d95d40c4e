"""Device traces, read from the profiler's raw records.

The padded session is a frozen copy of ``topfusion_tpu_torch/tools/timing.py``
(``PAD``, ``SESSIONS``, ``profiled``) at commit 81038a6: spin kernels
before and after the call, since a session can lose device events at
its edges, and of three sessions the one that counted the most.  The
records are read from ``prof.profiler.kineto_results.events()``, not
from the event tree, which takes tens of seconds for 10^5 records.
"""

from __future__ import annotations

import collections

import torch

PAD = 256
SESSIONS = 3
SPIN = "spin_kernel"


def _spin() -> None:
    for _ in range(PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _device_events(prof):
    """(name, start ns, end ns) of every device record but the pads."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA and SPIN not in e.name()
                and not e.name().startswith("fb:")):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def profiled(fn) -> dict:
    """``fn()`` in ``SESSIONS`` padded sessions: the device operations and
    their summed time (ms) of the session that counted the most, and how
    many sessions counted as many."""
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _spin()
            fn()
            _spin()
        ev = _device_events(prof)
        runs.append((len(ev), sum(b - a for _, a, b in ev) / 1e6))
    best = max(runs, key=lambda r: r[0])
    return {"ops": best[0], "device_ms": best[1],
            "agree": sum(r[0] == best[0] for r in runs)}


class Slice:
    """A profiled slice of the window: ``start()`` before its first
    chunk, ``stop()`` after its last; the harness's spans inside it are
    recorded as ``fb:<name>`` ranges."""

    def __init__(self, spans):
        self.spans = spans
        self.frames = 0
        self.result = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        _spin()
        self.spans.profiling = True
        self.rf = torch.profiler.record_function("fb:slice")
        self.rf.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.spans.profiling = False
        _spin()
        self.prof.__exit__(None, None, None)
        self.result = reduce(self.prof)
        self.prof = None


def reduce(prof) -> dict:
    """The slice's device operations against its host window (the
    ``fb:slice`` range): busy seconds (the union of the operations'
    intervals), the window's seconds, operations and their summed seconds
    by name, and the idle gaps with the innermost harness span the host
    was in when each began."""
    host = []
    dev = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The harness's ranges are mirrored on the device's timeline.
            if SPIN not in name and not name.startswith("fb:"):
                dev.append((a, b, name))
        elif name.startswith("fb:"):
            host.append((a, b, name[3:]))
    win = [h for h in host if h[2] == "slice"]
    if not win or not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": 0, "by_name": {}, "gaps": []}
    w0, w1 = win[0][0], win[0][1]
    by_name = collections.Counter()
    ops = 0
    ivs = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops += 1
        by_name[name] += (b - a) / 1e9
        ivs.append((a, b))
    ivs.sort()
    busy = 0
    gaps = []
    end = w0
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    spans = [h for h in host if h[2] != "slice"]

    def label(t):
        inner = [h for h in spans if h[0] <= t < h[1]]
        return min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "ops": ops,
        "by_name": dict(by_name),
        "gaps": [[label(a), (b - a) / 1e9] for a, b in gaps[:10]],
    }


def breakdown(result: dict) -> dict:
    """The ``breakdown`` of the result line: the ten device operations
    that took most time, and the ten longest idle gaps by what the host
    was doing."""
    top = sorted(result["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top], "idle_gaps": result["gaps"][:10]}
