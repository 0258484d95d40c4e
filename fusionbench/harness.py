"""One run of one cell: set-up, the measured window, the traced slice,
the comparison with the plain reference, and the result line.

The driver of the configuration's ``entry`` (``drivers/<entry>.py``)
does the work; this module times it, reads the metrics the cell reports
through their readers (``metrics/<name>.py``), and decides ``correct``.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import torch

from . import compare, spec
from .system import Spans, sync

FORBIDDEN = ("jax", "jaxlib", "flax", "topfusion_tpu")


class Run:
    """What a run knows and measures; the drivers fill it, the metric
    readers read it."""

    def __init__(self, cell, seed, seconds, trace, device, fault=None, control=False):
        self.cell = cell
        self.seed = int(seed) % (1 << 63)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.fault = fault
        self.control = control
        self.spans = Spans()
        self.setup_s = None
        self.window_s = None
        self.frames_done = 0
        self.attempted = 0
        self.failed = 0
        self.latencies = []     # open loop: seconds from each frame's due time to its pose
        self.chunk_s = []       # host seconds from a chunk's hand-off to its results
        self.solve_ms = []      # CUDA-event ms of each pose-graph solve in the window
        self.slice = None       # trace.Slice.result of the profiled slice
        self.slice_frames = 0
        self.integrate = []     # (updated voxels, live voxels, pool bytes) a slice frame
        self.stages = {}        # eager stage profiles after the window
        self.peak_reserved = None
        self.notes = {}         # what the run saw, printed on stderr

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        fault=None, control=False, overrides=None, bench=None) -> dict:
    """Run cell ``name`` once; returns the result object (and prints
    nothing).  ``overrides`` ({"config": {...}, "traffic": {...}})
    merges into the cell's files: the tests' small shapes.  ``fault``
    breaks the program's step underneath (the tests of the comparison);
    ``control`` also reports the control's numbers."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(name, bench)
    for key, over in (overrides or {}).items():
        cell[key] = _merge(cell[key], over)
    r = Run(cell, seed, seconds, trace, device, fault, control)
    drv = spec.driver(cell["config"]["entry"]).Driver(r)

    r.notes["setup_phases_s"] = {"imports": time.perf_counter() - t_start}
    r.notes["host"] = {"cpus": len(os.sched_getaffinity(0)), "torch_threads": torch.get_num_threads()}
    drv.setup()
    sync(r.device)
    r.setup_s = time.perf_counter() - t_start
    n_spans = len(r.spans.spans)
    drv.window()
    sync(r.device)
    by = {}
    for span, a, b in r.spans.spans[n_spans:]:
        by[span] = by.get(span, 0.0) + (b - a)
    r.notes["window_host_s"] = by
    if r.device.type == "cuda":
        r.peak_reserved = torch.cuda.max_memory_reserved(r.device)
    if r.trace:
        drv.after()
    drv.release()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, control_numbers = drv.check()
    r.notes["check_s"] = time.perf_counter() - t_check
    limits = cell["config"].get("limits", {})
    correct, checks = compare.verdict(numbers, limits)

    metrics = {}
    for m in cell["per_layer" if r.trace else "end_to_end"]:
        v = spec.metric_reader(m["name"]).read(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if r.device.type == "cuda" else r.device.type,
        "kind": torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": r.peak_reserved,
    }
    out = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": device_info}
    if r.trace and r.slice:
        from .trace import breakdown

        device_info["busy_s"] = r.slice["busy_s"]
        device_info["window_s"] = r.slice["window_s"]
        out["breakdown"] = breakdown(r.slice)
    out["notes"] = r.notes
    if control_numbers is not None:
        out["control"] = compare.verdict(control_numbers, limits)[1]
    out["checks"] = checks
    return out


def _fail(msg: str) -> int:
    sys.stderr.write(f"fusionbench: {msg}\n")
    return 1


def main(argv, t_start) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m fusionbench.run",
                                 description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also compare the control (the reference in TF32) with the reference")
    ap.add_argument("--traffic", default="{}",
                    help="JSON merged into the cell's traffic (a sweep of the open loop's rate)")
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return _fail(f"no workload {args.workload!r}")
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"the cell needs {chips} CUDA device(s) and this machine has {n}; "
                     "nothing is measured on the CPU")
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    sys.stderr.write(f"fusionbench: {args.workload} seed {args.seed}; {smi}\n")

    out = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
              control=args.control, overrides={"traffic": json.loads(args.traffic)},
              bench=bench)
    found = _forbidden_modules()
    if found:
        return _fail(f"the process loaded {', '.join(found)}: the benchmark measures "
                     "topfusion_tpu_torch alone")
    emit(out)
    return 0


def emit(out: dict) -> None:
    """The run's notes and each compared number beside its limit on
    standard error (its last lines), and the result line on standard
    output, the compared numbers under ``checks``, its last key."""
    out = dict(out)
    sys.stderr.write("fusionbench notes: " + json.dumps(out.pop("notes")) + "\n")
    if "control" in out:
        sys.stderr.write("control: " + json.dumps(out.pop("control")) + "\n")
    for k, c in out["checks"].items():
        sys.stderr.write(f"check {k}: {c['value']} (limit {c['limit']})\n")
    sys.stderr.flush()
    out["checks"] = out.pop("checks")
    print(json.dumps(out), flush=True)


