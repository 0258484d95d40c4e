"""The port's trace records (``utils/counters``): host spans, the stage
marks of the captured step and its chunk's device span, and the spans of
``SlamSystem.process_chunk``, on the CPU at the tiny test config cut to
40x32 (a step in under 0.1 s); and on the card the marks inside a
replayed graph.  This file imports no jax, so the card's cases run on a
GPU machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""

import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from topfusion_tpu_torch.config import CameraConfig, tiny_test_config
from topfusion_tpu_torch.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.models.captured import CapturedStep
from topfusion_tpu_torch.models.slam import SlamSystem
from topfusion_tpu_torch.utils import counters

torch.set_num_threads(2)

MARKS = ("start", "preproc", "icp", "alloc", "integrate", "maps", "end")


def small_config():
    cfg = tiny_test_config()
    return dataclasses.replace(
        cfg, camera=CameraConfig(width=40, height=32, fx=30.0, fy=30.0, cx=20.0, cy=16.0),
        blockmap=dataclasses.replace(cfg.blockmap, capacity=1 << 10, max_visible_blocks=1 << 9,
                                     max_new_blocks_per_frame=512))


def render(cfg, n, device="cpu"):
    scene = SyntheticScene()
    poses = orbit_trajectory(n, max_angle_deg=4.0, max_shift=0.04, seed=3)
    return torch.stack([scene.render_depth_mm(cfg.camera, torch.as_tensor(T, dtype=torch.float32))
                        for T in poses]).to(device)


def since(t0):
    return [r for r in counters.records() if r.t0 >= t0]


def assert_bit_identical(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert_bit_identical(x, y)
        else:
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


def test_spans_nest_and_the_ring_is_bounded(monkeypatch):
    """Spans carry their parent and the chunk of the outermost one; a
    span opened with no span open starts a chunk; the ring keeps the
    newest records and counts the ones it lets go; off, nothing is kept."""
    t0 = time.perf_counter_ns()
    with counters.span("outer"):
        for _ in range(2):
            with counters.span("inner"):
                with counters.span("leaf"):
                    pass
    with counters.span("next"):
        pass
    got = since(t0)
    outer, nxt = (next(r for r in got if r.name == n) for n in ("outer", "next"))
    inner = [r for r in got if r.name == "inner"]
    leaf = [r for r in got if r.name == "leaf"]
    assert outer.parent is None and nxt.parent is None and nxt.chunk != outer.chunk
    assert [r.parent for r in inner] == [outer.id] * 2
    assert [r.parent for r in leaf] == [r.id for r in inner]
    for r in inner + leaf:
        assert r.kind == "span" and r.chunk == outer.chunk
        assert outer.t0 <= r.t0 <= r.t1 <= outer.t1

    monkeypatch.setattr(counters, "_ring", collections.deque(maxlen=4))
    lost = counters.dropped()
    t1 = time.perf_counter_ns()
    for i in range(10):
        with counters.span(f"x{i}"):
            pass
    assert [r.name for r in counters.records()] == ["x6", "x7", "x8", "x9"]
    assert counters.dropped() == lost + 6
    # Each lost record is stamped with its start.
    assert counters.dropped(t1, time.perf_counter_ns()) == 6 and counters.dropped(t0, t1) == 0
    counters.enable(False)
    try:
        with counters.span("off"):
            pass
    finally:
        counters.enable(True)
    assert "off" not in {r.name for r in counters.records()}


def test_spans_are_profiler_ranges():
    """Under a profiler session a span is a range ``tf:<name>`` in an
    operator's scope, not a user annotation, which the profiler would
    mirror on the device's timeline as if it were device work.  (The
    autograd profiler's CPU session records the same ranges as a kineto
    session, whose first start takes seconds.)"""
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        with counters.span("probe"):
            torch.ones(4).sum()
        with torch.profiler.record_function("annotation"):
            pass
    kind = {e.name: e.is_user_annotation for e in prof.function_events}
    assert kind["tf:probe"] is False and kind["annotation"] is True


@pytest.fixture(scope="module")
def cpu_chunks():
    """A chunk of two frames through ``CapturedStep`` on the CPU (the eager
    step) from a fresh map, with the records on and off: (state, aux, the
    records it made)."""
    cfg = small_config()
    frames = render(cfg, 2)
    pipe = BlockPipeline(cfg, "cpu")
    out = {}
    for on in (True, False):
        counters.enable(on)
        try:
            t0 = time.perf_counter_ns()
            runner = CapturedStep(pipe, pipe.init())
            aux = runner.run(frames)
            out[on] = (runner.state(), aux, since(t0))
        finally:
            counters.enable(True)
    return out


def test_cpu_step_records_its_stages(cpu_chunks):
    """One device span for the chunk and one stage sample, of its last
    step, inside it: the five stages in order, the stamps monotone."""
    recs = cpu_chunks[True][2]
    chunk = [r for r in recs if r.kind == "device"]
    stages = [r for r in recs if r.kind == "stages"]
    assert len(chunk) == 1 and len(stages) == 1
    c, s = chunk[0], stages[0]
    assert (c.name, s.name, s.parent, s.chunk) == ("chunk", "step", c.id, c.chunk)
    assert c.t0 <= s.t0 <= s.t1 <= c.t1 and c.value == (c.t1 - c.t0) / 1e6
    assert tuple(m for m, _ in s.value) == MARKS
    ms = [v for _, v in s.value]
    assert ms[0] == 0.0 and all(a <= b for a, b in zip(ms, ms[1:]))
    assert ms[-1] <= (s.t1 - s.t0) / 1e6


def test_records_change_no_bit(cpu_chunks):
    (st_on, aux_on, _), (st_off, aux_off, recs_off) = cpu_chunks[True], cpu_chunks[False]
    assert recs_off == []
    assert_bit_identical(st_on, st_off)
    assert_bit_identical(aux_on, aux_off)


def test_slam_chunk_spans_lie_inside_their_parent():
    """A chunk through the eager SLAM system: ``slam.dispatch`` then
    ``slam.fetch``, each inside the chunk's ``slam.chunk`` and of its
    chunk."""
    cfg = small_config()
    frames = render(cfg, 1)
    slam = SlamSystem(cfg, device="cpu")
    t0 = time.perf_counter_ns()
    slam.process_chunk(frames)
    got = since(t0)
    parent = [r for r in got if r.name == "slam.chunk"]
    assert len(parent) == 1
    p = parent[0]
    kids = [r for r in got if r.parent == p.id]
    assert [r.name for r in kids] == ["slam.dispatch", "slam.fetch"]
    for k in kids:
        assert k.chunk == p.chunk and p.t0 <= k.t0 <= k.t1 <= p.t1
    assert kids[0].t1 <= kids[1].t0


@pytest.fixture(scope="module")
def card_chunk():
    """Four frames through ``CapturedStep`` on the card, and eagerly from
    the same state; the records the replays made."""
    if not torch.cuda.is_available():
        pytest.skip("the graph's marks are recorded on an NVIDIA GPU")
    cfg = tiny_test_config()
    frames = render(cfg, 4, "cuda")
    pipe = BlockPipeline(cfg, "cuda")
    state = pipe.init()
    eager, auxes = state, []
    for f in frames:
        eager, aux = pipe.step(eager, f)
        auxes.append(aux)
    runner = CapturedStep(pipe, state)
    t0 = time.perf_counter_ns()
    aux = runner.run(frames)
    torch.cuda.synchronize()
    return dict(recs=since(t0), eager=(eager, auxes), captured=(runner.state(), aux))


@pytest.mark.cuda
def test_graph_stage_times(card_chunk):
    """The last replay's stages, each positive, their sum at most the
    replay, the replay inside the chunk's device span."""
    recs = card_chunk["recs"]
    (s,) = [r for r in recs if r.kind == "stages"]
    (c,) = [r for r in recs if r.kind == "device"]
    assert s.name == "step" and tuple(m for m, _ in s.value) == MARKS
    ms = dict(s.value)
    parts = [ms[b] - ms[a] for a, b in zip(MARKS, MARKS[1:-1])]
    assert all(p > 0 for p in parts), s.value
    assert sum(parts) <= ms["end"] - ms["start"] <= c.value


@pytest.mark.cuda
def test_replay_with_marks_is_the_eager_step(card_chunk):
    from topfusion_tpu_torch.models.captured import stack_aux

    (st, auxes), (st_c, aux_c) = card_chunk["eager"], card_chunk["captured"]
    assert_bit_identical(st, st_c)
    assert_bit_identical(stack_aux(auxes), aux_c)
