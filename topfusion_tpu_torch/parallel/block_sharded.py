"""The block-sparse fusion step on a sharded block map (port of
``topfusion_tpu/parallel/block_sharded.py``), one process per shard over
``torch.distributed`` (``parallel/collectives.MapAxis``).

  * Ownership by hash: block coords hash into a global bucket space of
    ``nb_local * num_shards`` buckets; the low hash bits name the owning
    shard, the high bits the bucket in its local table
    (``ops/blockmap._bucket_owner``).
  * Allocation without communication on the map: every shard runs the
    same candidate pass (split over pixel rows, the strips gathered) and
    inserts only the blocks it owns.
  * Integration without communication: each shard fuses its own visible
    blocks, through the CUDA integrate kernel on the card.
  * Sort-last compositing: splat model maps and the display raycast run
    shard-locally; per-pixel winners are composited with one ``pmin`` of
    packed (depth | surfel id) keys and one masked ``psum`` of the
    winners' attributes (``ops/splat.py``), or a ``pmin`` of hit
    distances (``render``).
  * Data-parallel tracking: each shard builds ICP's normal equations
    from its strip of current-frame rows and the 7x7 Gram matrix is
    summed over the shards in every iteration (``ops/icp.py``).
  * Per-shard out-of-core swap: each shard evicts and restores its own
    blocks (``swap_evict`` / ``swap_insert``;
    ``models/host_cache.ShardedHostCache`` drives them).

Each process holds its LOCAL map, the slice ``[rank * cap_local :
(rank + 1) * cap_local]`` of the JAX package's global arrays
(``convert.sharded_block_state_from_numpy``), replicated pose and model
maps, and its own aged visible list.  With one shard, ownership is the
identity and every collective returns its input: the step is the
single-device ``BlockPipeline.step``, bit for bit.

Per frame the collectives are one sum per ICP iteration (the Gram matrix
and the count, 200 bytes), two gathers of the allocation candidates, the
key image's ``pmin`` (4 bytes a pixel), the attribute image's ``psum``
(20 bytes a pixel) and one sum of the step's counters.  No map-sized
state crosses shards.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import PipelineConfig, resolve_pallas_integrate
from ..models.block_pipeline import BlockPipeline, BlockState, BlockStepAux, shade
from ..ops.blockmap import make_block_map, select_block_map
from ..ops.cuda.integrate import integrate_blocks_cuda
from ..ops.depth import preprocess_depth
from ..ops.icp import icp_track
from ..ops.normals import build_maps_pyramid, normals_from_point_map, resize_points_normals
from ..ops.splat import splat_model_maps
from ..ops.swap import ExtractedBlocks, evict_blocks, extract_blocks, insert_blocks
from ..ops.tsdf_block import (
    allocate_from_depth,
    integrate_blocks,
    raycast_blocks,
    visible_blocks,
    visible_blocks_incremental,
)
from ..utils.device_info import entry_device
from .collectives import MapAxis, make_mesh


def _shard_cfg(cfg: PipelineConfig, ns: int) -> PipelineConfig:
    """Per-shard (local) capacities: the global capacity splits evenly."""
    bm = cfg.blockmap
    if bm.capacity % ns or bm.max_visible_blocks % ns:
        raise ValueError(
            f"capacity {bm.capacity} and max_visible_blocks {bm.max_visible_blocks} "
            f"must divide by the {ns} shards"
        )
    return dataclasses.replace(
        cfg,
        blockmap=dataclasses.replace(
            bm,
            capacity=bm.capacity // ns,
            max_visible_blocks=max(bm.max_visible_blocks // ns, 8),
            max_new_blocks_per_frame=max(bm.max_new_blocks_per_frame // ns, 64),
        ),
    )


class ShardedBlockPipeline:
    """``BlockPipeline`` on a block map sharded over ``axis`` (a
    ``MapAxis``; by default the initialized default process group), with
    this process's shard on ``device``: the card by default (a
    ``RuntimeError`` where there is none), ``"cpu"`` by name.

    Every member of the axis calls every method with the same arguments,
    in the same order: the methods issue collectives.  ``swap_evict`` and
    ``swap_insert`` issue none and act on this shard alone.
    """

    def __init__(self, cfg: PipelineConfig, axis: MapAxis | None = None, device="cuda"):
        self.cfg = cfg
        dev = entry_device(device)
        self.axis = make_mesh(dev) if axis is None else axis
        if self.axis.device.type != dev.type:
            raise ValueError(f"axis on {self.axis.device}, pipeline on {dev}")
        self.device = self.axis.device
        self.ns = self.axis.size
        self.shard = (self.axis.rank, self.ns)
        self.local_cfg = _shard_cfg(cfg, self.ns)

    # ------------------------------------------------------------------
    def init(self) -> BlockState:
        """This shard's empty local map, replicated pose and model maps,
        and an empty local visible list."""
        cfg, lc, dev = self.cfg, self.local_cfg, self.device
        m = make_block_map(lc.blockmap, use_color=cfg.tsdf.use_color, device=dev)
        mp, mn = [], []
        for level in range(cfg.preproc.pyramid_levels):
            cl = cfg.camera.at_level(level)
            mp.append(torch.zeros((cl.height, cl.width, 3), device=dev))
            mn.append(torch.zeros((cl.height, cl.width, 3), device=dev))
        return BlockState(
            *m,
            T_wc=torch.eye(4, device=dev),
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=torch.zeros((), dtype=torch.int32, device=dev),
            resets=torch.zeros((), dtype=torch.int32, device=dev),
            vis_slots=torch.full(
                (lc.blockmap.max_visible_blocks,), -1, dtype=torch.int32, device=dev
            ),
        )

    write_map = staticmethod(BlockPipeline.write_map)

    # ------------------------------------------------------------------
    def step(
        self, state: BlockState, depth_mm: torch.Tensor, rgb=None
    ) -> Tuple[BlockState, BlockStepAux]:
        """Fuse one depth frame [H, W] (u16 or integer millimetres), the
        same frame on every shard.  ``aux``'s counts are totals over the
        shards; the rest of ``aux`` and the pose are the same on every
        shard.  Color fusion is not sharded: ``rgb`` must be None."""
        if rgb is not None:
            raise NotImplementedError("the sharded pipeline does not fuse color")
        lc = self.local_cfg
        cam, bm, axis, ns = lc.camera, lc.blockmap, self.axis, self.ns
        dev = self.device
        depth_mm = depth_mm.to(dev)

        # Replicated frontend.
        raw_m, depth_pyr = preprocess_depth(depth_mm, lc.preproc)
        cur_pts, cur_nrm = build_maps_pyramid(cam, depth_pyr)

        # Data-parallel ICP over this shard's strip of rows (the rows past
        # ns * (h // ns) take no part, as in the JAX package).
        def rows(a):
            hl = a.shape[0] // ns
            return a[axis.rank * hl : (axis.rank + 1) * hl]

        is_first = state.frame == 0
        icp = icp_track(
            cam, lc.icp, state.T_wc, state.T_wc,
            [rows(p) for p in cur_pts], [rows(n) for n in cur_nrm],
            list(state.model_points), list(state.model_normals),
            axis=axis,
        )
        ok = icp.ok | is_first
        T_new = torch.where(is_first, state.T_wc, icp.T_wc)

        do_reset = (~ok) & bool(lc.reset_on_failure)
        T_int = torch.where(do_reset, torch.eye(4, device=dev), T_new)
        m = select_block_map(do_reset, state.block_map())
        raw_eff = torch.where(do_reset, 0.0, raw_m)

        # Owned allocation over row-sharded candidates.
        m, ainfo = allocate_from_depth(
            m, cam, lc.tsdf, bm, T_int, raw_eff, shard=self.shard,
            return_touched=True, row_shard=axis,
        )
        # Shard-local visible set, aged as on one device.
        d_cull = raw_eff if bm.visible_occlusion_cull else None
        full = visible_blocks(m, cam, lc.tsdf, bm, T_int, return_overflow=True, depth=d_cull)
        if bm.visible_aging:
            prev = torch.where(do_reset, -1, state.vis_slots)
            aged = visible_blocks_incremental(
                m, cam, lc.tsdf, bm, T_int, prev, ainfo.touched_slots,
                return_overflow=True, depth=d_cull,
            )
            rescan = (state.frame % max(bm.visible_rescan_every, 1) == 0) | do_reset
            full = tuple(torch.where(rescan, f, a) for f, a in zip(full, aged))
        *vis, vis_overflow = full
        vis = tuple(vis)

        # Shard-local integration: the kernel on the card.
        fn = integrate_blocks_cuda if resolve_pallas_integrate(bm, dev) else integrate_blocks
        m, n_vis = fn(m, cam, lc.tsdf, bm, T_int, raw_eff, vis)

        # Model maps: shard-local splat, composited over the shards.
        rc = splat_model_maps(
            m, cam, lc.tsdf, bm, T_int, vis,
            surfels_per_block=lc.raycast.surfels_per_block,
            dilate_passes=lc.raycast.dilate_passes,
            axis=axis,
        )
        mp, mn = [rc.points], [rc.normals]
        for _ in range(lc.preproc.pyramid_levels - 1):
            p, n = resize_points_normals(mp[-1], mn[-1])
            mp.append(p)
            mn.append(n)

        counts = axis.psum(torch.stack([
            m.num_blocks, ainfo.n_inserted, n_vis.to(torch.int32),
            ainfo.n_dropped_capacity, vis_overflow.to(torch.int32),
        ]))
        new_state = BlockState(
            *m,
            T_wc=T_int,
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=torch.where(do_reset, 0, state.frame + 1),
            resets=state.resets + do_reset.to(torch.int32),
            vis_slots=vis[0],
        )
        aux = BlockStepAux(
            ok=ok,
            residual=icp.residual,
            num_inliers=icp.num_inliers,
            was_reset=do_reset,
            num_blocks=counts[0],
            blocks_allocated=counts[1],
            num_visible=counts[2],
            blocks_dropped=counts[3],
            # The CUDA kernel reads the whole depth image: no window to skip.
            integrate_skipped=torch.zeros((), dtype=torch.int32, device=dev),
            visible_overflow=counts[4],
        )
        return new_state, aux

    # ------------------------------------------------------------------
    def swap_evict(
        self, state: BlockState, slots: torch.Tensor
    ) -> Tuple[BlockState, ExtractedBlocks, torch.Tensor]:
        """Evict this shard's LOCAL slots [K] (pad = -1): extract them,
        compact the local pool and remap the aged visible list.  Returns
        (state, the extracted payload, the old->new slot remap)."""
        bm = self.local_cfg.blockmap
        m = state.block_map()
        slots = slots.to(self.device)
        ex = extract_blocks(m, slots)
        m2, remap = evict_blocks(m, slots, bm, shard=self.shard)
        vis = state.vis_slots
        new_vis = torch.where(vis >= 0, remap[torch.clamp(vis, 0, bm.capacity - 1).long()], -1)
        return state._replace(**m2._asdict(), vis_slots=new_vis), ex, remap

    def swap_insert(
        self, state: BlockState, blocks: ExtractedBlocks
    ) -> Tuple[BlockState, torch.Tensor]:
        """Restore host-cached blocks that this shard owns into its local
        map.  Returns (state, restored mask [K])."""
        lc = self.local_cfg
        m2, ok = insert_blocks(
            state.block_map(), blocks, lc.blockmap, lc.tsdf.max_weight, shard=self.shard
        )
        return state._replace(**m2._asdict()), ok

    # ------------------------------------------------------------------
    def render(self, state: BlockState) -> torch.Tensor:
        """Phong-shaded uint8 [H, W, 3] view of the whole sharded map from
        the tracked pose: a shard-local march (gated on the nearest
        voxel's weight), then the nearest hit over the shards."""
        lc = self.local_cfg
        rc = raycast_blocks(
            state.block_map(), lc.camera, lc.tsdf, lc.blockmap, lc.raycast, state.T_wc,
            shard=self.shard, weight_gate="nearest",
        )
        big = 1e9
        t_local = torch.where(rc.hit, rc.depth, big)
        t_global = self.axis.pmin(t_local)
        mine = (t_global < big) & (t_local == t_global)
        points = self.axis.psum(torch.where(mine[..., None], rc.points, 0.0))
        normals = normals_from_point_map(points, state.T_wc[:3, 3])
        return shade(points, normals, state.T_wc)


# ----------------------------------------------------------------------
def dryrun_sharded_block_step(n_devices: int, axis: MapAxis | None = None, device="cuda") -> None:
    """The full sharded step at tiny shapes on a world of ``n_devices``
    shards (ownership, summed ICP, composited splat): two steps of a
    static frame and a render; tracking must hold.  Every member of
    ``axis`` (by default the initialized default process group) calls it."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )
    from ..io.synthetic import SyntheticScene

    dev = entry_device(device)
    axis = make_mesh(dev) if axis is None else axis
    if axis.size != n_devices:
        raise ValueError(f"need a world of {n_devices} shards, have {axis.size}")
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=512 * n_devices,
            max_new_blocks_per_frame=256 * n_devices,
            max_visible_blocks=256 * n_devices,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=48),
    )
    pipe = ShardedBlockPipeline(cfg, axis, dev)
    state = pipe.init()
    depth = SyntheticScene().render_depth_mm(cam, torch.eye(4, device=dev))
    state, aux = pipe.step(state, depth)
    state, aux = pipe.step(state, depth)
    img = pipe.render(state)
    if int(state.frame) != 2 or not bool(aux.ok) or int(aux.num_blocks) <= 0:
        raise RuntimeError(
            f"sharded block step failed a static frame: frame {int(state.frame)}, "
            f"ok {bool(aux.ok)}, blocks {int(aux.num_blocks)}"
        )
    if img.shape != (cam.height, cam.width, 3):
        raise RuntimeError(f"render shape {tuple(img.shape)}")
