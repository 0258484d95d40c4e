"""Streaming (pipelined) fusion: tracking and integration in different
processes, a frame in flight between them (port of
``topfusion_tpu/parallel/stream_pipeline.py``), over a world of
``2 x n_map`` processes of ``torch.distributed``.

World rank ``r`` is pipeline stage ``r // n_map`` and map shard
``r % n_map`` (the row-major order of the JAX ``make_pipe_mesh``):

    stage 0, step t:  preprocess depth_t; ICP against the model maps that
        stage 1 splatted from frame t-2 (received last step) -> pose_t.
        Sends (pose_t, raw_t, reset_t, valid) forward.
    stage 1, step t:  allocate, integrate and splat frame t-1 at
        pose_{t-1} (received last step) on a map sharded over its row of
        ``n_map`` processes, exactly as ``parallel/block_sharded.py``
        does (hash ownership, row-sharded candidates, sort-last splat
        compositing).  Sends the composited model maps and their pose
        back.

The JAX package runs one SPMD program whose branch is picked by the
mesh coordinate; here each stage is a process of its own that runs only
its stage.  The registers travel as two broadcasts over the pair group
``{j, n_map + j}`` of stage-0 rank ``j`` and its stage-1 partner, each
one way: the forward buffer from member 0, then the backward buffer
from member 1 (the JAX one-way ``ppermute`` pair).  After the exchange
the fields that travel the other way hold zeros, as the unsourced end
of a one-way ``ppermute`` does.  Each direction is packed into one
float32 buffer in a fixed field order; the flags travel as 0.0 / 1.0.

A tracking failure resets stage 0 to identity and raises ``reset``;
stage 1 wipes its shard, skips the frame and sends invalid maps back,
so both stages start again within two steps.

Kept from the reference as it is: stage-0 processes hold an idle copy of
their shard's map (1 / n_map of the pool each), the visible set is the
full scan with no occlusion cull and no aging whatever the config says,
and the model maps lag the tracked frame by two frames.  One difference:
on the card stage 1 fuses through the CUDA integrate kernel
(``config.resolve_pallas_integrate``), which is bit-equal to the plain
``integrate_blocks`` that the JAX stream runs.

With ``n_map`` stage-0 processes every one tracks the same frame and
sends its pose to its own partner: the replicas must agree to the bit,
which they do where their inputs and operations are the same.

Every member of a group must call that group's collectives in the same
order: stage 1 calls its row's on every step whatever the register's
flags (they are device bools, selected with ``torch.where``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import PipelineConfig, resolve_pallas_integrate
from ..models.block_pipeline import BlockPipeline, BlockState
from ..ops.blockmap import select_block_map
from ..ops.cuda.integrate import integrate_blocks_cuda
from ..ops.depth import preprocess_depth
from ..ops.icp import icp_track
from ..ops.normals import build_maps_pyramid, resize_points_normals
from ..ops.splat import splat_model_maps
from ..ops.tsdf_block import allocate_from_depth, integrate_blocks, visible_blocks
from ..utils.device_info import entry_device
from .block_sharded import _shard_cfg
from .collectives import MapAxis


class StreamRegister(NamedTuple):
    """Pipeline registers of one process.  ``pose/raw/reset/valid`` travel
    0 -> 1; ``maps_p/maps_n/maps_pose/maps_valid`` travel 1 -> 0."""

    pose: torch.Tensor                    # [4, 4] stage0 -> stage1
    raw: torch.Tensor                     # [H, W] meters, stage0 -> stage1
    reset: torch.Tensor                   # () bool, stage0 -> stage1
    valid: torch.Tensor                   # () bool: register carries a frame
    maps_p: Tuple[torch.Tensor, ...]      # model points pyr, stage1 -> stage0
    maps_n: Tuple[torch.Tensor, ...]      # model normals pyr, stage1 -> stage0
    maps_pose: torch.Tensor               # [4, 4] pose the maps were splatted from
    maps_valid: torch.Tensor              # () bool


_FWD_FIELDS = ("pose", "raw", "reset", "valid")
_BWD_FIELDS = ("maps_p", "maps_n", "maps_pose", "maps_valid")


class PipeMesh(NamedTuple):
    """This process's place in the pipe x map world: its ``stage``, the
    ``map`` axis over its stage's row of ``n_map`` processes, and the
    ``link`` over its pair group (member 0 the stage-0 process)."""

    stage: int
    map: MapAxis
    link: MapAxis

    @property
    def n_map(self) -> int:
        return self.map.size

    @property
    def device(self) -> torch.device:
        return self.map.device


def make_pipe_mesh(n: int = 2, n_map: int = 1, device="cuda") -> PipeMesh:
    """The ``2 x n_map`` mesh over the initialized default group, on
    ``device`` (the card unless the caller names another).  Every process
    of the world calls it: it makes the ``n_map`` pair groups and then
    the two rows, in that order, on every rank."""
    dev = entry_device(device)
    if n != 2:
        raise ValueError(f"the streaming pipeline has 2 stages, not {n}")
    if not dist.is_initialized():
        raise RuntimeError("make_pipe_mesh: torch.distributed is not initialized")
    world = dist.get_world_size()
    if n_map < 1 or world != 2 * n_map:
        raise ValueError(f"a 2 x {n_map} mesh needs a world of {2 * n_map}, have {world}")
    pairs = [dist.new_group([j, n_map + j]) for j in range(n_map)]
    rows = [dist.new_group(list(range(s * n_map, (s + 1) * n_map))) for s in range(2)]
    stage, mid = divmod(dist.get_rank(), n_map)
    return PipeMesh(stage, MapAxis(rows[stage], dev), MapAxis(pairs[mid], dev))


# ----------------------------------------------------------------- registers
def _levels(cfg: PipelineConfig):
    return [cfg.camera.at_level(i) for i in range(cfg.preproc.pyramid_levels)]


def init_register(cfg: PipelineConfig, device) -> StreamRegister:
    """The register before the first step: identity poses, zero depth
    and model maps, flags False."""
    false = torch.zeros((), dtype=torch.bool, device=device)
    maps = tuple(torch.zeros((c.height, c.width, 3), device=device) for c in _levels(cfg))
    return StreamRegister(
        pose=torch.eye(4, device=device),
        raw=torch.zeros((cfg.camera.height, cfg.camera.width), device=device),
        reset=false, valid=false.clone(),
        maps_p=maps, maps_n=tuple(torch.zeros_like(x) for x in maps),
        maps_pose=torch.eye(4, device=device), maps_valid=false.clone(),
    )


def _leaves(reg: StreamRegister, fields) -> list:
    out = []
    for name in fields:
        v = getattr(reg, name)
        out += list(v) if isinstance(v, tuple) else [v]
    return out


def _numel(reg: StreamRegister, fields) -> int:
    return sum(t.numel() for t in _leaves(reg, fields))


def _pack(reg: StreamRegister, fields) -> torch.Tensor:
    """``fields`` of ``reg`` in one float32 buffer, in order (flags as
    0.0 / 1.0)."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in _leaves(reg, fields)])


def _unpack(buf: torch.Tensor, like: StreamRegister, fields) -> dict:
    """The inverse of ``_pack``, shaped and typed as ``like``'s fields."""
    leaves = _leaves(like, fields)
    parts = torch.split(buf, [t.numel() for t in leaves])
    vals = [p.reshape(t.shape) != 0 if t.dtype == torch.bool else p.reshape(t.shape)
            for p, t in zip(parts, leaves)]
    out, i = {}, 0
    for name in fields:
        v = getattr(like, name)
        k = len(v) if isinstance(v, tuple) else 1
        out[name] = tuple(vals[i:i + k]) if isinstance(v, tuple) else vals[i]
        i += k
    return out


def link_bytes(cfg: PipelineConfig) -> Tuple[int, int]:
    """Bytes of one step's forward and backward buffers."""
    reg = init_register(cfg, "meta")
    return 4 * _numel(reg, _FWD_FIELDS), 4 * _numel(reg, _BWD_FIELDS)


def _zero_fields(reg: StreamRegister, fields) -> dict:
    return {name: (tuple(torch.zeros_like(t) for t in getattr(reg, name))
                   if isinstance(getattr(reg, name), tuple) else torch.zeros_like(getattr(reg, name)))
            for name in fields}


def exchange(link: MapAxis, stage: int, out: StreamRegister) -> StreamRegister:
    """One step's register exchange over the pair group ``link``: the
    forward buffer broadcast from member 0, then the backward buffer from
    member 1.  Each process keeps what the other stage sent; the fields
    it sent itself come back as zeros."""
    dev = out.pose.device
    if stage == 0:
        fwd = link.broadcast(_pack(out, _FWD_FIELDS), src=0)
        bwd = link.broadcast(torch.empty(_numel(out, _BWD_FIELDS), device=dev), src=1)
        return out._replace(**_zero_fields(out, _FWD_FIELDS), **_unpack(bwd, out, _BWD_FIELDS))
    fwd = link.broadcast(torch.empty(_numel(out, _FWD_FIELDS), device=dev), src=0)
    bwd = link.broadcast(_pack(out, _BWD_FIELDS), src=1)
    return out._replace(**_unpack(fwd, out, _FWD_FIELDS), **_zero_fields(out, _BWD_FIELDS))


def exchange_in_process(out0: StreamRegister, out1: StreamRegister):
    """The exchange of a pair of stages held in one process: (stage 0's
    register, stage 1's register) after it, as ``exchange`` gives them."""
    reg0 = out0._replace(**_zero_fields(out0, _FWD_FIELDS),
                         **{f: getattr(out1, f) for f in _BWD_FIELDS})
    reg1 = out1._replace(**{f: getattr(out0, f) for f in _FWD_FIELDS},
                         **_zero_fields(out1, _BWD_FIELDS))
    return reg0, reg1


# ----------------------------------------------------------------- stages
def stage_track(local_cfg: PipelineConfig, cfg: PipelineConfig, state: BlockState,
                reg: StreamRegister, depth_mm: torch.Tensor):
    """Stage 0 of one step: track ``depth_mm`` against the register's
    model maps (frame t-2, splatted at ``reg.maps_pose``).  Returns
    (state, the outgoing register)."""
    lc = local_cfg
    cam = lc.camera
    dev = state.T_wc.device
    raw, pyr = preprocess_depth(depth_mm.to(dev), lc.preproc)
    cp, cn = build_maps_pyramid(cam, pyr)
    # Pipeline fill (the first two frames) tracks at the carried pose.
    bootstrap = state.frame < 2
    # Associate in the camera that rendered the register's maps (frame
    # t-2), not this stage's own last pose (frame t-1).
    T_model = torch.where(reg.maps_valid, reg.maps_pose, state.T_wc)
    icp = icp_track(cam, cfg.icp, state.T_wc, T_model, cp, cn,
                    list(reg.maps_p), list(reg.maps_n))
    ok = icp.ok | bootstrap | ~reg.maps_valid
    do_reset = (~ok) & bool(cfg.reset_on_failure)
    T_new = torch.where(bootstrap | ~icp.ok | ~reg.maps_valid, state.T_wc, icp.T_wc)
    T_new = torch.where(do_reset, torch.eye(4, device=dev), T_new)
    new_state = state._replace(
        T_wc=T_new,
        # A reset drops back into the 2-frame bootstrap window.
        frame=torch.where(do_reset, 0, state.frame + 1),
        resets=state.resets + do_reset.to(torch.int32),
    )
    out = reg._replace(
        pose=T_new,
        # The failed frame is discarded.
        raw=torch.where(do_reset, 0.0, raw),
        reset=do_reset,
        valid=torch.ones((), dtype=torch.bool, device=dev),
    )
    return new_state, out


def stage_map(local_cfg: PipelineConfig, cfg: PipelineConfig, state: BlockState,
              reg: StreamRegister, shard: Tuple[int, int], map_axis: MapAxis | None):
    """Stage 1 of one step: allocate, integrate and splat the register's
    frame at its pose on shard ``shard = (map rank, n_map)`` of the map;
    ``map_axis`` is the row (None with one shard).  Returns (state, the
    outgoing register)."""
    lc = local_cfg
    cam, bm = lc.camera, lc.blockmap
    # A reset from the tracker wipes this shard and skips the frame.
    m = select_block_map(reg.reset, state.block_map())
    use = reg.valid & ~reg.reset
    raw_eff = torch.where(use, reg.raw, 0.0)
    T_int = reg.pose
    m, _ = allocate_from_depth(m, cam, lc.tsdf, bm, T_int, raw_eff, shard=shard,
                               row_shard=map_axis)
    # The full scan: no occlusion cull and no aging, as in the reference.
    vis = visible_blocks(m, cam, lc.tsdf, bm, T_int)
    fn = integrate_blocks_cuda if resolve_pallas_integrate(bm, raw_eff.device) else integrate_blocks
    m, _ = fn(m, cam, lc.tsdf, bm, T_int, raw_eff, vis)
    rc = splat_model_maps(m, cam, lc.tsdf, bm, T_int, vis,
                          surfels_per_block=lc.raycast.surfels_per_block,
                          dilate_passes=lc.raycast.dilate_passes, axis=map_axis)
    mp, mn = [rc.points], [rc.normals]
    for _ in range(lc.preproc.pyramid_levels - 1):
        p, n = resize_points_normals(mp[-1], mn[-1])
        mp.append(p)
        mn.append(n)
    new_state = BlockPipeline.write_map(state, m)._replace(
        frame=state.frame + 1, model_points=tuple(mp), model_normals=tuple(mn))
    out = reg._replace(maps_p=tuple(mp), maps_n=tuple(mn), maps_pose=T_int, maps_valid=use)
    return new_state, out


def init_stage(local_cfg: PipelineConfig, device):
    """A process's empty (state, register), the same on both stages: the
    single-device empty state of its shard's local configuration (a map
    idle on stage 0) and ``init_register``."""
    return BlockPipeline(local_cfg, device).init(), init_register(local_cfg, device)


def run_lockstep(cfg: PipelineConfig, depths, device="cuda"):
    """Both stages of a ``2 x 1`` pipeline in this process, stepped in
    lockstep with the registers swapped by hand (``exchange_in_process``):
    the reference a world of two processes is held to.  Returns
    ((stage-0 state, register), (stage-1 state, register), stage 0's
    poses [N, 4, 4])."""
    dev = entry_device(device)
    lc = _shard_cfg(cfg, 1)
    s0, r0 = init_stage(lc, dev)
    s1, r1 = init_stage(lc, dev)
    poses = []
    for d in depths:
        s0, o0 = stage_track(lc, cfg, s0, r0, d)
        s1, o1 = stage_map(lc, cfg, s1, r1, (0, 1), None)
        r0, r1 = exchange_in_process(o0, o1)
        poses.append(s0.T_wc)
    return (s0, r0), (s1, r1), torch.stack(poses)


# ----------------------------------------------------------------- pipeline
class StreamBlockPipeline:
    """The 2-stage streaming pipeline on this process's place in the mesh
    (``make_pipe_mesh``; by default a ``2 x 1`` mesh over the default
    group), on ``device``: the card unless the caller names another.
    Every process of the world calls every method in the same order."""

    def __init__(self, cfg: PipelineConfig, mesh: PipeMesh | None = None, device="cuda"):
        dev = entry_device(device)
        self.mesh = make_pipe_mesh(2, 1, dev) if mesh is None else mesh
        if self.mesh.device.type != dev.type:
            raise ValueError(f"mesh on {self.mesh.device}, pipeline on {dev}")
        self.cfg = cfg
        self.device = self.mesh.device
        self.stage = self.mesh.stage
        self.nm = self.mesh.n_map
        self.shard = (self.mesh.map.rank, self.nm)
        self.local_cfg = _shard_cfg(cfg, self.nm)

    def init(self) -> Tuple[BlockState, StreamRegister]:
        """This process's slice of the JAX ``init``: (state, register)."""
        return init_stage(self.local_cfg, self.device)

    def run_stage(self, state: BlockState, reg: StreamRegister, depth_mm: torch.Tensor):
        """This process's stage of one step, before the exchange."""
        if self.stage == 0:
            return stage_track(self.local_cfg, self.cfg, state, reg, depth_mm)
        return stage_map(self.local_cfg, self.cfg, state, reg, self.shard,
                         self.mesh.map if self.nm > 1 else None)

    def step(self, state: BlockState, reg: StreamRegister, depth_mm: torch.Tensor):
        """One pipeline step: this stage, then the register exchange."""
        state, out = self.run_stage(state, reg, depth_mm)
        return state, exchange(self.mesh.link, self.stage, out)

    def run(self, state: BlockState, reg: StreamRegister, depths):
        """Step every frame of ``depths`` [N, H, W] (the same frames on
        every process).  Returns (state, register, this process's
        ``T_wc`` after each step [N, 4, 4])."""
        poses = []
        for d in depths:
            state, reg = self.step(state, reg, d)
            poses.append(state.T_wc)
        return state, reg, torch.stack(poses)


# ----------------------------------------------------------------- entry points
def dryrun_stream_step(n_devices: int, mesh: PipeMesh | None = None, device="cuda") -> None:
    """The full streaming step at tiny shapes on a ``2 x (n_devices // 2)``
    mesh: four frames of a static scene; stage 0 must have advanced four
    frames and stage 1's row must hold blocks.  Every process of the
    world calls it."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )
    from ..io.synthetic import SyntheticScene

    if n_devices < 2:
        return  # a pipeline needs 2 stages; single-device paths cover n = 1
    dev = entry_device(device)
    n_map = max(n_devices // 2, 1)
    mesh = make_pipe_mesh(2, n_map, dev) if mesh is None else mesh
    if mesh.n_map != n_map:
        raise ValueError(f"need a 2 x {n_map} mesh, have 2 x {mesh.n_map}")
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=512 * n_map,
            max_new_blocks_per_frame=256 * n_map,
            max_visible_blocks=256 * n_map,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=48),
    )
    pipe = StreamBlockPipeline(cfg, mesh, dev)
    state, reg = pipe.init()
    depth = SyntheticScene().render_depth_mm(cam, torch.eye(4, device=dev))
    state, reg, poses = pipe.run(state, reg, [depth] * 4)
    if not bool(torch.isfinite(poses).all()):
        raise RuntimeError("stream dry run: non-finite pose")
    if pipe.stage == 0:
        if int(state.frame) != 4:
            raise RuntimeError(f"stream dry run: stage 0 at frame {int(state.frame)}, not 4")
    elif int(mesh.map.psum(state.num_blocks)) <= 0:
        raise RuntimeError("stream dry run: stage 1 never integrated")


def run_stream(cfg: PipelineConfig, depths, mesh: PipeMesh | None = None, device="cuda"):
    """Run the chunk ``depths`` [N, H, W] through the streaming pipeline
    (by default a ``2 x 1`` mesh over the default group) and return stage
    0 map-shard 0's tracked pose per frame, numpy [N, 4, 4], on every
    process of the world."""
    dev = entry_device(device)
    pipe = StreamBlockPipeline(cfg, mesh, dev)
    state, reg = pipe.init()
    if not isinstance(depths, torch.Tensor):
        depths = torch.from_numpy(np.asarray(depths))
    depths = depths.to(pipe.device)
    _, _, poses = pipe.run(state, reg, depths)
    return MapAxis(None, pipe.device).broadcast(poses, src=0).cpu().numpy()
