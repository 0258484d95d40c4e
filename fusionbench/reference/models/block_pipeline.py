# Frozen copy of topfusion_tpu_torch/models/block_pipeline.py at commit 81038a6, the yardstick's plain reference,
# trimmed to what BlockPipeline.step reaches (the display renders left out).
"""Block-sparse fusion pipeline (port of
``topfusion_tpu/models/block_pipeline.py``): one voxel-hashed fusion
step per depth (or depth + RGB) frame, on the card unless the caller
names another device.

Per frame: preprocess -> vertex/normal pyramid -> frame-to-model ICP ->
reset on failure -> allocate from depth -> visible set (aged, with a
full rescan every ``visible_rescan_every`` frames) -> integrate ->
color fusion (``use_color`` and an RGB frame) -> model maps (splat, or
the guided / full raycast) -> their pyramid.

The step issues no host sync (no ``.item()``, no Python branch on a
device value): the reset is a ``torch.where`` over the map, and the
rescan computes both visible sets and selects.  With its shapes fixed by
the configuration, it can be captured whole as a CUDA graph
(``models/captured.CapturedStep``).

The step does not modify the state it is given: the reset select writes
new map tensors, into which integration then writes in place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig
from ..ops.blockmap import (
    BlockMap,
    make_block_map,
    select_block_map,
)
from ..ops.depth import preprocess_depth
from ..ops.icp import icp_track
from ..ops.normals import build_maps_pyramid, resize_points_normals
from ..ops.splat import splat_model_maps
from ..ops.tsdf_block import (
    allocate_from_depth,
    integrate_blocks,
    integrate_color_blocks,
    raycast_blocks,
    visible_blocks,
    visible_blocks_incremental,
)
from ..utils.device_info import entry_device


class BlockState(NamedTuple):
    bucket_keys: torch.Tensor
    bucket_slots: torch.Tensor
    block_coords: torch.Tensor
    tsdf: torch.Tensor
    weight: torch.Tensor
    num_blocks: torch.Tensor
    color: torch.Tensor          # [C+1,B,B,B,3] or [1,1,1,1,3] dummy
    T_wc: torch.Tensor
    model_points: Tuple[torch.Tensor, ...]
    model_normals: Tuple[torch.Tensor, ...]
    frame: torch.Tensor
    resets: torch.Tensor
    # Last frame's visible slots ([max_visible_blocks] int32, -1 = empty).
    vis_slots: torch.Tensor

    def block_map(self) -> BlockMap:
        return BlockMap(*self[: len(BlockMap._fields)])


class BlockStepAux(NamedTuple):
    ok: torch.Tensor
    residual: torch.Tensor
    num_inliers: torch.Tensor
    was_reset: torch.Tensor
    num_blocks: torch.Tensor
    blocks_allocated: torch.Tensor
    num_visible: torch.Tensor
    # New unique blocks rejected by pool exhaustion this frame.
    blocks_dropped: torch.Tensor
    # Voxels the TPU kernel's window guard skipped: always 0 here, as on
    # the JAX package's XLA path (the CUDA kernel has no window).
    integrate_skipped: torch.Tensor
    # Frustum-visible allocated blocks truncated by max_visible_blocks.
    visible_overflow: torch.Tensor


class BlockPipeline:
    """Functional block-sparse pipeline on ``device``: the card by
    default (a ``RuntimeError`` where there is none), ``"cpu"`` by name."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = entry_device(device)

    def init(self) -> BlockState:
        cfg = self.cfg
        dev = self.device
        m = make_block_map(cfg.blockmap, use_color=cfg.tsdf.use_color, device=dev)
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
                (cfg.blockmap.max_visible_blocks,), -1, dtype=torch.int32, device=dev
            ),
        )

    @staticmethod
    def write_map(state: BlockState, m: BlockMap) -> BlockState:
        """Replace the map fields of a state."""
        return state._replace(**m._asdict())

    def step_rgb(
        self, state: BlockState, depth_mm: torch.Tensor, rgb: torch.Tensor
    ) -> Tuple[BlockState, BlockStepAux]:
        """Fusion step that also fuses the registered RGB frame [H, W, 3]
        into the map's color pool (``cfg.tsdf.use_color`` must be on)."""
        return self.step(state, depth_mm, rgb)

    def step(
        self,
        state: BlockState,
        depth_mm: torch.Tensor,
        rgb: torch.Tensor | None = None,
    ) -> Tuple[BlockState, BlockStepAux]:
        """Fuse one depth frame [H, W] (u16 or integer millimetres); with
        ``rgb`` and ``cfg.tsdf.use_color`` its color too."""
        cfg = self.cfg
        cam = cfg.camera
        bm = cfg.blockmap
        depth_mm = depth_mm.to(self.device)

        raw_m, depth_pyr = preprocess_depth(depth_mm, cfg.preproc)
        cur_pts, cur_nrm = build_maps_pyramid(cam, depth_pyr)

        is_first = state.frame == 0
        icp = icp_track(
            cam, cfg.icp, state.T_wc, state.T_wc, cur_pts, cur_nrm,
            list(state.model_points), list(state.model_normals),
        )
        ok = icp.ok | is_first
        T_new = torch.where(is_first, state.T_wc, icp.T_wc)

        do_reset = (~ok) & bool(cfg.reset_on_failure)
        T_int = torch.where(do_reset, torch.eye(4, device=self.device), T_new)
        m = select_block_map(do_reset, state.block_map())

        # Discard the failed frame: an all-invalid depth allocates and
        # fuses nothing.
        raw_eff = torch.where(do_reset, 0.0, raw_m)

        m, ainfo = allocate_from_depth(
            m, cam, cfg.tsdf, bm, T_int, raw_eff, return_touched=True,
        )
        d_cull = raw_eff if bm.visible_occlusion_cull else None
        full = visible_blocks(
            m, cam, cfg.tsdf, bm, T_int, return_overflow=True, depth=d_cull,
        )
        if bm.visible_aging:
            # Aged set (last frame's list, wiped on reset, + this frame's
            # touched blocks); every N-th frame and after a reset the full
            # rescan.  Both are computed and selected on the device.
            prev = torch.where(do_reset, -1, state.vis_slots)
            aged = visible_blocks_incremental(
                m, cam, cfg.tsdf, bm, T_int, prev, ainfo.touched_slots,
                return_overflow=True, depth=d_cull,
            )
            rescan = (state.frame % max(bm.visible_rescan_every, 1) == 0) | do_reset
            full = tuple(torch.where(rescan, f, a) for f, a in zip(full, aged))
        *vis, vis_overflow = full
        vis = tuple(vis)

        m, n_vis = self.integrate(m, T_int, raw_eff, vis)

        if cfg.tsdf.use_color and rgb is not None:
            m = integrate_color_blocks(
                m, cam, cfg.tsdf, bm, T_int, raw_eff, rgb.to(self.device), vis
            )

        # Model maps for the next frame: forward-projected surface voxels
        # by default, else a sphere march (guided by the depth just fused,
        # or over the whole frustum).
        if cfg.raycast.model_maps == "splat":
            rc = splat_model_maps(
                m, cam, cfg.tsdf, bm, T_int, vis,
                surfels_per_block=cfg.raycast.surfels_per_block,
                dilate_passes=cfg.raycast.dilate_passes,
            )
        elif cfg.raycast.guided:
            rc = raycast_blocks(
                m, cam, cfg.tsdf, bm, cfg.raycast, T_int,
                expected_depth=raw_eff,
                depth_margin=cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist,
                max_steps=cfg.raycast.guided_max_steps,
            )
        else:
            rc = raycast_blocks(m, cam, cfg.tsdf, bm, cfg.raycast, T_int)
        mp, mn = [rc.points], [rc.normals]
        for _ in range(cfg.preproc.pyramid_levels - 1):
            p, n = resize_points_normals(mp[-1], mn[-1])
            mp.append(p)
            mn.append(n)

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
            num_blocks=m.num_blocks,
            blocks_allocated=ainfo.n_inserted,
            num_visible=n_vis,
            blocks_dropped=ainfo.n_dropped_capacity,
            integrate_skipped=torch.zeros((), dtype=torch.int32, device=self.device),
            visible_overflow=vis_overflow,
        )
        return new_state, aux

    def integrate(self, m: BlockMap, T_wc: torch.Tensor, depth: torch.Tensor, vis):
        """Fuse ``depth`` (float32 metres) at ``T_wc`` into the visible
        blocks: the integrate kernel, or its plain version, as
        ``config.resolve_pallas_integrate`` chooses.  Returns (map,
        num_visible)."""
        cfg = self.cfg
        return integrate_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc, depth, vis)
