"""The port's compiled entry points: a pipeline's step captured as a
CUDA graph (the counterpart of the JAX package's ``jax.jit(pipe._step)``),
and the pieces the SLAM system's graphs are built of
(``models/slam.CapturedSlam``: its chunk, solve and re-integration, the
JAX package's ``jax.jit``s of ``_chunk_impl``, ``_optimize_ex_impl`` and
``_reint_impl``, topfusion_tpu/models/slam.py:117-120).

    runner = CapturedStep(pipe, state)    # warm-up, then one step captured
    aux = runner.run(frames)              # [n, H, W] on the card: n replays
    state = runner.state()

In the JAX package one dispatch runs a whole compiled step (and
``bench.py`` a ``lax.scan`` of them).  Here the eager step is some 7200
kernel launches, whose host cost is most of a frame's time; the graph
launches them all at once.  ``run`` is ``bench.py``'s ``run_chunk``
without the scan: a copy of each frame into the graph's depth buffer and
one replay, and the frame's aux copied into slot i of its outputs.  It
reads nothing back, so a chunk of frames makes no host sync; the caller
syncs once at its end.

Any pipeline whose ``step(state, depth_mm)`` has shapes fixed by its
configuration and makes no host sync can be captured: ``BlockPipeline``,
and ``ShardedBlockPipeline`` over NCCL (whose collectives go into the
graph).  The state lives in static device buffers; the graph computes
the next state from them (the step stays functional and writes new
tensors) and copies it back into them, so the map's pool is copied once
a frame (2 x 64 MiB at the bench configuration).

On the card ``CapturedStep`` always captures, and a capture that fails
raises.  Given a state on the CPU it runs the eager step instead, so the
CPU tests drive the same calls.

The launch counts the wrappers keep in Python (``utils/counters``: the
integrate kernel's, the eig6 kernel's, the map axis's collectives)
advance when a wrapper is called, so once while a graph is captured (and
once per warm-up step, which ran).  Each capture reads every registered
count around itself, keeps what it counted (``per_replay``, by count
name), takes it back (nothing ran), and adds it on every replay, so each
count stays the number of launches that ran.

``Graph`` is one capture and its counts; ``CapturedStep`` is a step's.
``models/slam.CapturedSlam`` builds the SLAM system's graphs on both,
with the state helpers ``map_state``, ``copy_into`` and ``stack_aux``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import counters

# The eager steps that build the kernel library, the solver handles and
# the communicators, and fill the allocator, before the capture.
WARMUP_STEPS = 2


def _fields(state: NamedTuple):
    """(name, tensor) of a state, its tuple fields (model pyramids)
    flattened as ``name.i``."""
    for name, v in state._asdict().items():
        if isinstance(v, tuple):
            for i, t in enumerate(v):
                yield f"{name}.{i}", t
        else:
            yield name, v


def map_state(fn, state: NamedTuple) -> NamedTuple:
    """``fn`` of every tensor of a state (tuple fields element by element)."""
    return type(state)(*[
        tuple(fn(t) for t in v) if isinstance(v, tuple) else fn(v) for v in state
    ])


def _copy_state(dst: NamedTuple, src: NamedTuple) -> None:
    for (name, d), (_, s) in zip(_fields(dst), _fields(src)):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"CapturedStep: {name} is {tuple(s.shape)} {s.dtype}, "
                             f"the captured step takes {tuple(d.shape)} {d.dtype}")
        d.copy_(s)


def copy_into(dst: NamedTuple, src: NamedTuple) -> None:
    """``_copy_state`` that skips the fields ``src`` shares with ``dst``
    (a tensor written in place, or one the graph left alone)."""
    for (name, d), (_, s) in zip(_fields(dst), _fields(src)):
        if s is not d:
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(f"{name} is {tuple(s.shape)} {s.dtype}, the captured "
                                 f"buffer {tuple(d.shape)} {d.dtype}")
            d.copy_(s)


def stack_aux(auxes: list) -> NamedTuple:
    """Per-frame auxes as one, each field stacked to [n]."""
    return type(auxes[0])(*[torch.stack(v) for v in zip(*auxes)])


class Graph:
    """``fn()`` captured once as a CUDA graph on the current device, with
    the registered launch counts it adds per replay (see the module
    docstring).  ``pool`` is a memory pool shared with other graphs
    (``torch.cuda.graph_pool_handle()``)."""

    def __init__(self, fn, pool=None):
        torch.cuda.synchronize()
        before = counters.read()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: NCCL's watchdog thread polls its events while
        # the sharded step's collectives are being captured.
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            fn()
        # The capture launched nothing: what it counted is one replay's.
        self.counts = []  # (owner, attribute, count)
        self.per_replay = {}
        for (o, a), v in counters.read().items():
            d = v - before.get((o, a), 0)
            if d:
                setattr(o, a, v - d)
                self.counts.append((o, a, d))
                self.per_replay[counters.name(o, a)] = d

    def replay(self) -> None:
        self.graph.replay()
        for o, a, d in self.counts:
            setattr(o, a, getattr(o, a) + d)


class CapturedStep:
    """``pipe.step`` captured once for ``state``'s shapes on its device
    (or run eagerly for a state on the CPU), for u16 depth frames in
    millimetres and, with ``rgb``, registered uint8 color frames.
    ``adopt``: the graph's buffers are ``state``'s own tensors (which
    must be contiguous and unaliased), not copies; ``pool``: a memory
    pool shared with other graphs."""

    def __init__(self, pipe, state: NamedTuple, rgb: bool = False, pool=None,
                 adopt: bool = False):
        self.pipe = pipe
        self.device = state.T_wc.device
        self.per_replay = {}
        self.graph = None
        cam = pipe.cfg.camera
        self.frame_shape = (cam.height, cam.width)
        if self.device.type != "cuda":
            self._state = state
            return
        with torch.cuda.device(self.device), torch.no_grad():
            self._static = state if adopt else map_state(torch.clone, state)
            self._depth = torch.zeros(self.frame_shape, dtype=torch.int32,
                                      device=self.device).to(torch.uint16)
            self._rgb = (torch.zeros((*self.frame_shape, 3), dtype=torch.uint8,
                                     device=self.device) if rgb else None)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step(self._static, self._depth, self._rgb)
            torch.cuda.current_stream(self.device).wait_stream(side)

            def step():
                new_state, self._aux = self._step(self._static, self._depth, self._rgb)
                _copy_state(self._static, new_state)

            self.graph = Graph(step, pool)
            self.per_replay = self.graph.per_replay

    def _step(self, state, depth, rgb):
        return self.pipe.step(state, depth) if rgb is None else self.pipe.step(state, depth, rgb)

    def replay(self) -> None:
        """One step on the frame in the depth buffer (and the color
        buffer): the graph, and the counts it launches."""
        self.graph.replay()

    def run(self, frames, rgbs=None) -> NamedTuple:
        """Step every frame of ``frames`` ([n, H, W], or a list of [H, W],
        on the runner's device) in order, with ``rgbs`` ([n, H, W, 3])
        for a runner made with ``rgb``; returns the step's aux with each
        field stacked to [n].  No host sync on the card."""
        if self.graph is None:
            auxes = []
            for i, f in enumerate(frames):
                self._state, aux = self._step(self._state, f, None if rgbs is None else rgbs[i])
                auxes.append(aux)
            return stack_aux(auxes)
        if (rgbs is None) != (self._rgb is None):
            raise ValueError("CapturedStep.run: color frames go with a runner made with rgb")
        n = len(frames)
        out = type(self._aux)(*[torch.empty((n, *a.shape), dtype=a.dtype, device=self.device)
                                for a in self._aux])
        for i in range(n):
            f = frames[i]
            if f.device != self.device or tuple(f.shape) != self.frame_shape:
                raise ValueError(f"CapturedStep.run: frame {i} is {tuple(f.shape)} on {f.device}; "
                                 f"the graph takes {self.frame_shape} on {self.device}")
            self._depth.copy_(f)
            if rgbs is not None:
                self._rgb.copy_(rgbs[i])
            self.replay()
            for dst, src in zip(out, self._aux):
                dst[i].copy_(src)
        return out

    def state(self) -> NamedTuple:
        """The state after the last step (a copy on the card: the next
        replay overwrites the graph's buffers)."""
        if self.graph is None:
            return self._state
        return map_state(torch.clone, self._static)

    def load(self, state: NamedTuple) -> None:
        """Make ``state`` (same shapes and device) the one the next step
        starts from."""
        if self.graph is None:
            self._state = state
            return
        for name, t in _fields(state):
            if t.device != self.device:
                raise ValueError(f"CapturedStep.load: {name} is on {t.device}, "
                                 f"the graph on {self.device}")
        _copy_state(self._static, state)
