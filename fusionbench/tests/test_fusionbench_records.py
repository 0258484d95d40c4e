"""The readers of the program's trace records count only the window's
records before the traced slice, those between the start of the first
and the end of the last of the window's harness spans that precede it,
and read None where there are none or where the program lost one."""

import collections

import pytest

from fusionbench import harness, spec
from topfusion_tpu_torch.utils import counters
from topfusion_tpu_torch.utils.counters import Record

MARKS = ("start", "preproc", "icp", "alloc", "integrate", "maps", "end")
# Chunk i's records read i ms a stage or span, 6i a replay, 150i a device
# span.  The window holds chunks 1-6, and the slice would start at chunk
# 4 (SLAM: 6 // 2 chunks before it; hash: the chunks ending within 5 s of
# the first's start), so chunks 1-3 count, to the start of chunk 4:
# medians 2 and 12, a mean of 12, 900 ms of device time in the 4.5 s
# their spans cover (three of the chunk's spans and their fetches).
EXPECT = {
    "hash_vga.orbit": {"preproc_ms.graph": 2.0, "icp_ms.graph": 2.0, "alloc_ms.graph": 2.0,
                       "integrate_ms.graph": 2.0, "maps_ms.graph": 2.0,
                       "replay_ms.graph": 12.0, "idle_share.events": 80.0},
    "slam_vga.live_orbit": {"dispatch_ms.live": 2.0, "fetch_ms.live": 2.0,
                            "tail_ms.graph": 12.0, "solve_ms.graph": 12.0},
}


def synthetic_records() -> list:
    out = []
    for i in range(8):
        t = int((100.25 + 2 * i) * 1e9)
        stages = tuple((m, float(i * k)) for k, m in enumerate(MARKS))
        out += [Record("stages", g, 0, None, i, t, t + 1000, stages)
                for g in ("step", "tail", "solve")]
        out.append(Record("device", "chunk", 0, None, i, t, t + 1000, 150.0 * i))
        out += [Record("span", n, 0, None, i, t, t + i * 10**6, None)
                for n in ("slam.dispatch", "slam.fetch")]
    return out


def synthetic_run(cell: str):
    """Seven harness spans of the cell's chunk, 1 s each from 100 s, 2 s
    apart, each followed by a fetch of 0.5 s, in a run of 10 s; the window
    is the last six chunk spans, and the 0.5 s after each fetch is no
    span's."""
    r = harness.Run(spec.cell(cell), 1, 10.0, True, "cpu")
    name = "run" if cell.startswith("hash") else "process_chunk"
    for i in range(7):
        r.spans.spans += [(name, 100.0 + 2 * i, 101.0 + 2 * i),
                          ("fetch", 101.0 + 2 * i, 101.5 + 2 * i)]
    r.notes["chunks"] = 6
    return r


def test_readers_count_the_window_alone(monkeypatch):
    for cell, expect in EXPECT.items():
        run = synthetic_run(cell)
        assert set(expect) <= {m["name"] for m in spec.cell(cell)["per_layer"]}
        monkeypatch.setattr(counters, "records", synthetic_records)
        got = {m: spec.metric_reader(m).read(run) for m in expect}
        assert got == pytest.approx(expect), cell
        # A record lost after the counted chunks changes nothing; one
        # lost among them leaves nothing to read.
        monkeypatch.setattr(counters, "_drops", collections.deque([int(110e9)]))
        assert {m: spec.metric_reader(m).read(run) for m in expect} == pytest.approx(expect), cell
        monkeypatch.setattr(counters, "_drops", collections.deque([int(104e9)]))
        assert all(spec.metric_reader(m).read(run) is None for m in expect), cell
        monkeypatch.setattr(counters, "_drops", collections.deque())
        monkeypatch.setattr(counters, "records", list)
        assert all(spec.metric_reader(m).read(run) is None for m in expect), cell
        # A program without the records (an older tree) reads None too.
        monkeypatch.delattr(counters, "records")
        assert all(spec.metric_reader(m).read(run) is None for m in expect), cell
        monkeypatch.undo()
