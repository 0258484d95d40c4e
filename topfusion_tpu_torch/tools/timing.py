"""Timing rows shared by the profilers of ``topfusion_tpu_torch.tools``.

The JAX scripts fence a leaf of each result; here:

  * latency: ``torch.cuda.synchronize()`` after each call (the host's
    launch cost and the device's work, one call at a time);
  * pipelined: n calls queued between two CUDA events, one sync: per call
    the larger of the device's time and the host's cost of enqueueing;
  * device ms and device operations per call: ``torch.profiler`` (the
    kernels' summed time, and their count; ``profiled``), in SESSIONS
    sessions: a session can lose device events, so the row takes the
    session that counted the most and says how many sessions agreed.

On the CPU the clock is the host's and the device columns read "-".
"""

from __future__ import annotations

import argparse
import collections
import time

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; raises without one; "
                    "cpu runs on the CPU)")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# Spin kernels (``torch.cuda._sleep``) before and after the call in each
# profiler session.  A session can lose device events (57-58 a session in
# chip_smoke.py's long process on an H100, whole rows of a few operations
# among them); the pads are not counted, and the number of them a session
# kept shows a loss they took.  ``profiler_check`` measures what they do.
PAD = 256
SESSIONS = 3


def profiled(fn, *args, pad: bool = True):
    """``fn(*args)`` once under the profiler, between the pads (or bare):
    (device operations, their summed time in ms, Counter of device
    microseconds by kernel name, pad kernels recorded, Counter of
    launches by kernel name)."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(PAD if pad else 0):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin()
        fn(*args)
        spin()
    by_name = collections.Counter()
    launches = collections.Counter()
    ops = pads = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "spin_kernel" in e.name:
            pads += 1
            continue
        by_name[e.name] += e.time_range.elapsed_us()
        launches[e.name] += 1
        ops += 1
    return ops, sum(by_name.values()) / 1000.0, by_name, pads, launches


def profiler_check(device) -> dict:
    """The profiler against a count known in advance: 100 one-kernel
    calls (``x.add_(1)``) profiled in 5 sessions with the pads and 5
    without, alternately.  Returns the operations each session recorded,
    by "padded" and "bare", and the pad kernels each padded session kept
    ("pads", of 2 * PAD)."""
    x = torch.zeros(1024, device=device)

    def fn():
        for _ in range(100):
            x.add_(1)

    out = {"padded": [], "bare": [], "pads": []}
    for _ in range(5):
        ops, _, _, pads, _ = profiled(fn)
        out["padded"].append(ops)
        out["pads"].append(pads)
        out["bare"].append(profiled(fn, pad=False)[0])
    return out


class Timer:
    """Prints one row per ``row()`` call and keeps it in ``rows``."""

    def __init__(self, device, n: int = 10, lat_calls: int = 3, width: int = 28):
        self.device = torch.device(device)
        self.n, self.lat_calls, self.width = n, lat_calls, width
        self.rows: list[dict] = []

    def _pipelined_ms(self, fn, args) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(self.n):
                fn(*args)
            return (time.perf_counter() - t0) * 1000 / self.n
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(self.n):
            fn(*args)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / self.n

    def row(self, name: str, fn, *args):
        out = fn(*args)  # warm: the kernel build, the allocator's blocks
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(self.lat_calls):
            out = fn(*args)
            sync(self.device)
        lat = (time.perf_counter() - t0) * 1000 / self.lat_calls
        pipe = self._pipelined_ms(fn, args)
        rec = dict(name=name, lat_ms=lat, pipelined_ms=pipe, device_ms=None, ops=None,
                   kernels=collections.Counter(), sessions=None)
        if self.device.type == "cuda":
            runs = [profiled(fn, *args) for _ in range(SESSIONS)]
            # A lost event only lowers a session's count: take the most.
            rec["ops"], rec["device_ms"], rec["kernels"], _, _ = max(runs, key=lambda r: r[0])
            rec["sessions"] = [r[0] for r in runs]
        self.rows.append(rec)
        print(self.format(rec), flush=True)
        if rec["sessions"] and len(set(rec["sessions"])) > 1:
            print(f"  # {name}: the profiler's sessions counted {rec['sessions']} operations "
                  f"(pad kernels kept {[r[3] for r in runs]} of {2 * PAD} each)", flush=True)
        return out

    def format(self, rec: dict) -> str:
        dev = "-" if rec["device_ms"] is None else f"{rec['device_ms']:9.3f}"
        ops = "-" if rec["ops"] is None else rec["ops"]
        agree = ""
        if rec.get("sessions"):
            agree = f"   ({rec['sessions'].count(rec['ops'])}/{len(rec['sessions'])} agree)"
        return (f"{rec['name']:{self.width}s}   lat {rec['lat_ms']:9.3f} ms   "
                f"pipelined {rec['pipelined_ms']:9.3f} ms   device {dev:>9s} ms   ops {ops:>6}"
                + agree)

    def header(self) -> str:
        return (f"# {self.device}: latency = a sync after each of {self.lat_calls} calls; "
                f"pipelined = {self.n} calls queued, one sync; device ms and ops = one "
                f"call, profiled in {SESSIONS} sessions (the most operations; how many "
                f"sessions counted as many)"
                + ("" if self.device.type == "cuda" else " (not measured off the card)"))
