"""Multi-process runtime: bring-up, per-rank checkpoints, the elastic
block-pipeline demo and the scaling harness (port of
``topfusion_tpu/parallel/multihost.py``).

The JAX package brings up ``jax.distributed`` and lets XLA place the
collectives on a global mesh.  Here a world is a ``torch.distributed``
process group, one process per shard: ``initialize_multihost`` joins
one from its arguments or from the environment that launchers set
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``), and
``parallel.launch.spawn_world`` starts one on this host.

One card can hold a world of one NCCL process, or gloo processes that
share it: that measures the sharded path's overhead and the contention
of one host, not scaling.  ``measure_scaling`` and
``measure_scaling_block`` say which they measured.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.checkpoint import _leaves, _rebuild
from .collectives import MapAxis, make_mesh
from .launch import spawn_world


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[str]:
    """Join this process to a world of ``num_processes``: the coordinator
    ``"host:port"``, the count and this process's rank come from the
    arguments or else from ``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  A single process needs no world: a
    no-op then, as in the JAX package.  NCCL where every process of this
    host (``LOCAL_WORLD_SIZE``, else the whole world) has a card of its
    own, and this process takes card ``LOCAL_RANK`` (else its rank);
    gloo otherwise.  Returns the backend, or None for the no-op."""
    env = os.environ
    n = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    if n <= 1 and not coordinator_address:
        return None
    rank = process_id if process_id is not None else int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_n = int(env.get("LOCAL_WORLD_SIZE", n))
    backend = "gloo"
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_n:
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % local_n)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=n, rank=rank, timeout=datetime.timedelta(seconds=600))
    return backend


# ------------------------------------------------------------------ checkpoints
def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save_sharded_checkpoint(path: str, state, frame_idx: int, poses, rank: Optional[int] = None) -> None:
    """This process's checkpoint of a sharded state: every leaf of its
    local ``state`` (in JAX's pytree order) under ``leaf{i}_dev{rank}``,
    the JAX package's key scheme with this process's rank as the device,
    plus ``__frame__`` and ``__poses__``; written to a temporary name and
    renamed.  A bfloat16 leaf is written widened to float32 (exact), as
    ``utils/checkpoint.save_state`` does."""
    rank = _rank() if rank is None else rank
    out = {
        "__frame__": np.asarray(frame_idx),
        "__poses__": np.stack(poses) if len(poses) else np.zeros((0, 4, 4)),
    }
    for i, x in enumerate(_leaves(state)):
        x = x.detach().cpu()
        out[f"leaf{i}_dev{rank}"] = (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()
    tmp = f"{path}.tmp{rank}.npz"  # np.savez keeps a name ending in .npz
    np.savez(tmp, **out)
    os.replace(tmp, path)


def restore_sharded_checkpoint(path: str, like, rank: Optional[int] = None):
    """This process's part of a ``save_sharded_checkpoint`` into a state
    shaped like ``like`` (its local state: dtypes, shapes and device).
    Returns (state, frame index, list of poses)."""
    rank = _rank() if rank is None else rank
    with np.load(path) as data:
        leaves = []
        for i, ref in enumerate(_leaves(like)):
            arr = data[f"leaf{i}_dev{rank}"]
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"{path}: leaf {i} has shape {arr.shape}, the state "
                                 f"{tuple(ref.shape)}: another configuration")
            leaves.append(torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype))
        frame, poses = int(data["__frame__"]), list(data["__poses__"])
    return _rebuild(like, iter(leaves)), frame, poses


def check_same_frame(axis: MapAxis, frame: int, what: str) -> None:
    """Raise on every member unless all members restored the same frame
    (``frame`` < 0: this member failed to restore).  One gather."""
    got = axis.all_gather_tiled(torch.tensor([frame], dtype=torch.int64, device=axis.device))
    frames = got.cpu().tolist()
    if min(frames) < 0 or len(set(frames)) != 1:
        raise RuntimeError(f"{what}: the members restored frames {frames} (-1: failed); a world "
                           "resumes only from one checkpoint of every member")


# ------------------------------------------------------------------ demo
def _demo_config(ns: int):
    """The demo's tiny configuration (the JAX demo's), capacities scaled
    by the shard count."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )

    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(3, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=512 * ns,
            max_new_blocks_per_frame=256 * ns,
            max_visible_blocks=256 * ns,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=48),
    )


def run_block_pipeline_demo(
    axis: Optional[MapAxis] = None,
    n_frames: int = 4,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 0,
    on_frame=None,
) -> dict:
    """The sharded block pipeline over a fixed tiny synthetic orbit on
    every member of ``axis`` (by default the initialized default group, on
    the card); every member calls it.  With ``ckpt_path`` each member
    keeps ``{ckpt_path}.proc{rank}.npz``, written every ``ckpt_every``
    frames, and a restarted world resumes from it (the elastic restart:
    the whole world re-forms and each member restores its own shard).
    ``on_frame(k, state)`` runs after frame k.  Returns the poses, the
    last frame's block and visible counts, and the frame it resumed at."""
    from ..io.synthetic import SyntheticScene, orbit_trajectory
    from .block_sharded import ShardedBlockPipeline

    axis = make_mesh() if axis is None else axis
    dev = axis.device
    cfg = _demo_config(axis.size)
    scene = SyntheticScene()
    gt = orbit_trajectory(n_frames, max_angle_deg=2.0, max_shift=0.02, seed=7)
    frames = [scene.render_depth_mm(cfg.camera, torch.as_tensor(T, device=dev)) for T in gt]
    pipe = ShardedBlockPipeline(cfg, axis, dev)
    state = pipe.init()
    poses, start = [], 0
    mine = f"{ckpt_path}.proc{axis.rank}.npz" if ckpt_path else None
    if mine is not None and os.path.exists(mine):
        state, start, poses = restore_sharded_checkpoint(mine, state, axis.rank)
    if mine is not None:
        # Members that resume at different frames would issue different
        # collectives and wait for each other forever: refuse instead.
        check_same_frame(axis, start, f"{ckpt_path}.proc*.npz")
    aux = None
    for k in range(start, len(frames)):
        state, aux = pipe.step(state, frames[k])
        if not bool(aux.ok):
            raise RuntimeError(f"the sharded demo lost tracking at frame {k}")
        poses.append(state.T_wc.cpu().numpy())
        if mine is not None and ckpt_every and (k + 1) % ckpt_every == 0:
            save_sharded_checkpoint(mine, state, k + 1, poses, axis.rank)
        if on_frame is not None:
            on_frame(k, state)
    return {
        "poses": np.stack(poses),
        "num_blocks": int(aux.num_blocks),
        "num_visible": int(aux.num_visible),
        "resumed_at": start,
    }


# ------------------------------------------------------------------ scaling
def _timed_frames(step, state, frames) -> float:
    """Frames per second of two passes over ``frames`` after two warm-up
    steps, on the host's clock around synchronized work."""
    state, _ = step(state, frames[0])
    state, _ = step(state, frames[1])
    sync = torch.cuda.synchronize if frames[0].is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    n = 0
    for _ in range(2):
        for f in frames:
            state, _ = step(state, f)
            n += 1
    sync()
    return n / (time.perf_counter() - t0)


def _orbit_frames(cam, n_frames: int, dev):
    from ..io.synthetic import SyntheticScene, orbit_trajectory

    scene = SyntheticScene()
    poses = orbit_trajectory(n_frames, max_angle_deg=3.0, max_shift=0.03)
    return [scene.render_depth_mm(cam, torch.as_tensor(T, device=dev)) for T in poses]


def _dense_body(axis: MapAxis, cfg, n_frames: int) -> float:
    """Frames/s of the sharded dense step on one member of a world."""
    from .sharded_pipeline import make_sharded_pipeline

    init, step = make_sharded_pipeline(cfg, axis)
    return _timed_frames(step, init(), _orbit_frames(cfg.camera, n_frames, axis.device))


def _block_body(axis: MapAxis, cfg, n_frames: int) -> float:
    """Frames/s of the sharded block step on one member of a world."""
    from .block_sharded import ShardedBlockPipeline

    pipe = ShardedBlockPipeline(cfg, axis, axis.device)
    return _timed_frames(pipe.step, pipe.init(), _orbit_frames(cfg.camera, n_frames, axis.device))


def _scaling(body, cfg_for, n_frames: int, device_counts, device, efficiency) -> dict:
    """``body``'s frames/s (rank 0's) in a world of each count, started by
    ``spawn_world``; the efficiency only where every process had a card
    of its own."""
    from ..utils.device_info import entry_device

    dev = entry_device(device)
    every = max(torch.cuda.device_count(), 1) if dev.type == "cuda" else 1
    counts = [every if c is None else c for c in device_counts]
    results: dict = {"device": str(dev), "backend": {}, "cards": {}}
    for n in counts:
        if dev.type != "cuda":
            backend, cards = "gloo", 0
        else:  # NCCL where every process has a card of its own
            cards = min(n, torch.cuda.device_count())
            backend = "nccl" if cards == n else "gloo"
        results[n] = spawn_world(body, n, backend, str(dev), args=(cfg_for(n), n_frames))[0]
        results["backend"][n], results["cards"][n] = backend, cards
    n_max = max(counts)
    results["efficiency"] = None
    if len(counts) < 2 or counts[0] != 1:
        results["efficiency_note"] = "not computed: needs a world of 1 first and a larger one"
    elif results["cards"][n_max] < n_max:
        results["efficiency_note"] = (
            f"not computed: {n_max} processes on {results['cards'][n_max]} card(s) "
            f"({results['backend'][n_max]}): the sharded path's overhead and one host's "
            "contention, not scaling")
    else:
        results["efficiency"] = efficiency(results, n_max)
        results["efficiency_note"] = "every process on a card of its own"
    return results


def measure_scaling(cfg, n_frames: int = 8, device_counts=(1, None), device="cuda") -> dict:
    """Fused frames/s of the sharded dense pipeline in a world of each of
    ``device_counts`` processes (None: one per card) on ``device`` (the
    card unless named).  Returns ``{n: frames/s, "backend": {n: ...},
    "cards": {n: cards used}, "efficiency": fps_N / (N * fps_1) or None,
    "efficiency_note": why}``."""
    return _scaling(_dense_body, lambda n: cfg, n_frames, device_counts, device,
                    lambda r, n: r[n] / (n * r[1]))


def measure_scaling_block(cfg, n_frames: int = 6, device_counts=(1, 2, 4, 8), mode: str = "weak",
                          device="cuda") -> dict:
    """Fused frames/s of the sharded block pipeline in a world of each of
    ``device_counts`` processes on ``device`` (the card unless named).
    ``mode="weak"`` holds each shard's working set (the global capacity
    and visible budget grow with the world): efficiency fps_N / fps_1;
    ``"strong"`` holds the global problem: fps_N / (N * fps_1).  Returns
    as ``measure_scaling`` does, with ``"mode"``."""
    import dataclasses

    def cfg_for(n):
        if mode != "weak":
            return cfg
        bm = cfg.blockmap
        return dataclasses.replace(cfg, blockmap=dataclasses.replace(
            bm, capacity=bm.capacity * n, max_visible_blocks=bm.max_visible_blocks * n,
            max_new_blocks_per_frame=bm.max_new_blocks_per_frame * n))

    weak = mode == "weak"
    out = _scaling(_block_body, cfg_for, n_frames, device_counts, device,
                   lambda r, n: r[n] / r[1] if weak else r[n] / (n * r[1]))
    out["mode"] = mode
    return out
