"""Structured per-frame metrics + timing (a copy of
``topfusion_tpu/utils/metrics.py``: the port imports nothing of the JAX
package).

Replaces the reference's cout-only observability (pose prints at
tfusion/src/topfu.cpp:246-252, FPS sampling at tfusion/src/core.cpp:202-221,
``ScopeTime``/``SampledScopeTime`` at tfusion/include/tfusion/types.hpp:83-104)
with structured JSONL records and a proper completion-fenced frame timer;
the scope timers' counterpart is ``utils/counters.span``.
"""

from __future__ import annotations

import json
import time
from typing import IO, Any, Dict, List, Optional

import numpy as np


class MetricsLogger:
    """Append-only JSONL sink of per-frame records + rolling FPS."""

    def __init__(self, path: Optional[str] = None, print_every: int = 33):
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self.print_every = print_every
        self.records: List[Dict[str, Any]] = []
        self._t_last = time.perf_counter()
        self._frame_times: List[float] = []

    def reset_timer(self) -> None:
        """Restart the frame clock (call after warmup/compile phases so
        the first frame doesn't absorb them)."""
        self._t_last = time.perf_counter()

    def log_frame(self, record: Dict[str, Any]) -> None:
        now = time.perf_counter()
        record = dict(record)
        record["frame_time_s"] = now - self._t_last
        self._frame_times.append(record["frame_time_s"])
        self._t_last = now
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        # Sampled FPS print, cadence mirrors the reference (every 33 frames,
        # reference: apps/demo.cpp:102-105).
        n = len(self._frame_times)
        if self.print_every and n % self.print_every == 0:
            window = self._frame_times[-self.print_every :]
            fps = len(window) / max(sum(window), 1e-9)
            print(f"[metrics] frame {n}: {fps:.1f} fps (avg over {len(window)})")

    def summary(self) -> Dict[str, Any]:
        if not self.records:
            return {}
        times = np.asarray(self._frame_times)
        out: Dict[str, Any] = {
            "frames": len(self.records),
            "fps_mean": float(1.0 / times.mean()),
            "frame_time_p50_ms": float(np.percentile(times, 50) * 1000),
            "frame_time_p95_ms": float(np.percentile(times, 95) * 1000),
        }
        for key in ("inliers", "blocks", "residual"):
            vals = [r[key] for r in self.records if key in r]
            if vals:
                out[f"{key}_mean"] = float(np.mean(vals))
        out["resets"] = sum(1 for r in self.records if r.get("reset"))
        out["loops"] = sum(1 for r in self.records if r.get("loop"))
        return out

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
