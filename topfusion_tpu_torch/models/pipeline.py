"""Dense-volume fusion pipeline (port of ``topfusion_tpu/models/pipeline.py``):
one fusion step per depth (or depth + RGB) frame over a fixed voxel grid,
and the shaded and color renders of it, on the card unless the caller
names another device.

Per frame: preprocess -> vertex/normal pyramid -> frame-to-model ICP ->
reset on failure -> integrate -> color fusion (``use_color`` and an RGB
frame) -> raycast from the new pose (guided by the depth just fused, or
over the whole volume) -> the model maps' pyramid.  The model maps fed
to ICP are that raycast, not the previous sensor frame.

As in ``models/block_pipeline.py`` the step issues no host sync: the
reset is a ``torch.where`` over the volume.  The step does not modify
the state it is given.  The renders make no host sync either.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig
from ..ops.depth import preprocess_depth
from ..ops.icp import icp_track
from ..ops.normals import build_maps_pyramid, resize_points_normals
from ..ops.rendering import phong_shade
from ..ops.tsdf_dense import (
    DenseVolume,
    RaycastResult,
    integrate_color_dense,
    integrate_dense,
    make_color_volume,
    make_dense_volume,
    raycast_dense,
    sample_color_dense,
)
from ..utils.device_info import entry_device
from ..utils.numerics import true_div, vec


class DenseState(NamedTuple):
    """Carried fusion state (tensors on the pipeline's device)."""

    tsdf: torch.Tensor                 # [D0, D1, D2]
    weight: torch.Tensor               # [D0, D1, D2]
    color: torch.Tensor                # [D0, D1, D2, 3] (1-voxel dummy if off)
    T_wc: torch.Tensor                 # (4, 4) current camera-to-world pose
    model_points: Tuple[torch.Tensor, ...]   # world-space raycast pyramid
    model_normals: Tuple[torch.Tensor, ...]
    frame: torch.Tensor                # () int32
    resets: torch.Tensor               # () int32, tracking-failure resets

    def volume(self) -> DenseVolume:
        return DenseVolume(self.tsdf, self.weight)


class StepAux(NamedTuple):
    ok: torch.Tensor
    residual: torch.Tensor
    num_inliers: torch.Tensor
    was_reset: torch.Tensor


class DensePipeline:
    """Functional dense-volume pipeline on ``device``: the card by default
    (a ``RuntimeError`` where there is none), ``"cpu"`` by name.

        pipe = DensePipeline(cfg)
        state = pipe.init()
        state, aux = pipe.step(state, depth_mm)
    """

    # The voxels of dim 0 this pipeline's volume holds: all of them.  The
    # sharded dense pipeline (parallel/sharded_pipeline.py) holds a slab
    # and gathers the whole volume for the raycast (``_whole``).
    slab = None

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = entry_device(device)

    def _whole(self, *grids: torch.Tensor) -> tuple:
        """The whole grids (of dims ``cfg.dense.dims``) that the raycast
        and the renders read, from this pipeline's part of them."""
        return grids

    def init(self) -> DenseState:
        cfg = self.cfg
        dev = self.device
        vol = make_dense_volume(cfg.dense, device=dev)
        mp, mn = [], []
        for level in range(cfg.preproc.pyramid_levels):
            cl = cfg.camera.at_level(level)
            mp.append(torch.zeros((cl.height, cl.width, 3), device=dev))
            mn.append(torch.zeros((cl.height, cl.width, 3), device=dev))
        return DenseState(
            tsdf=vol.tsdf,
            weight=vol.weight,
            color=make_color_volume(cfg.dense, cfg.tsdf.use_color, device=dev),
            T_wc=torch.eye(4, device=dev),
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=torch.zeros((), dtype=torch.int32, device=dev),
            resets=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def step_rgb(
        self, state: DenseState, depth_mm: torch.Tensor, rgb: torch.Tensor
    ) -> Tuple[DenseState, StepAux]:
        """Fusion step that also fuses the registered RGB frame [H, W, 3]
        into the color grid (``cfg.tsdf.use_color`` must be on)."""
        return self.step(state, depth_mm, rgb)

    def step(
        self,
        state: DenseState,
        depth_mm: torch.Tensor,
        rgb: torch.Tensor | None = None,
    ) -> Tuple[DenseState, StepAux]:
        """Fuse one depth frame [H, W] (u16 or integer millimetres); with
        ``rgb`` and ``cfg.tsdf.use_color`` its color too."""
        cfg = self.cfg
        cam = cfg.camera
        depth_mm = depth_mm.to(self.device)

        raw_m, depth_pyr = preprocess_depth(depth_mm, cfg.preproc)
        cur_pts, cur_nrm = build_maps_pyramid(cam, depth_pyr)

        # Tracking (its result is not used on frame 0).
        is_first = state.frame == 0
        icp = icp_track(
            cam, cfg.icp, state.T_wc, state.T_wc, cur_pts, cur_nrm,
            list(state.model_points), list(state.model_normals),
        )
        ok = icp.ok | is_first
        T_new = torch.where(is_first, state.T_wc, icp.T_wc)

        # Tracking failure: wipe the map, restart from identity, discard
        # the failed frame and make the next frame take the frame-0 path,
        # all selected on the device.
        do_reset = (~ok) & bool(cfg.reset_on_failure)
        T_int = torch.where(do_reset, torch.eye(4, device=self.device), T_new)
        vol = DenseVolume(
            tsdf=torch.where(do_reset, 1.0, state.tsdf),
            weight=torch.where(do_reset, 0.0, state.weight),
        )

        # Integration from the RAW metric depth; an all-invalid depth
        # image integrates nothing, which discards the failed frame.
        raw_eff = torch.where(do_reset, 0.0, raw_m)
        vol = integrate_dense(vol, cam, cfg.tsdf, cfg.dense, T_int, raw_eff, self.slab)

        color = state.color
        if cfg.tsdf.use_color and rgb is not None:
            color = torch.where(do_reset, 0.0, color)
            color = integrate_color_dense(
                color, vol, cam, cfg.tsdf, cfg.dense, T_int, raw_eff,
                rgb.to(self.device), self.slab,
            )

        # Raycast for the next frame's model maps: a band around the depth
        # just fused when guided, else the whole volume.
        whole = DenseVolume(*self._whole(vol.tsdf, vol.weight))
        if cfg.raycast.guided:
            rc = raycast_dense(
                whole, cam, cfg.tsdf, cfg.dense, cfg.raycast, T_int,
                expected_depth=raw_eff,
                depth_margin=cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist,
                max_steps=cfg.raycast.guided_max_steps,
            )
        else:
            rc = raycast_dense(whole, cam, cfg.tsdf, cfg.dense, cfg.raycast, T_int)
        mp, mn = [rc.points], [rc.normals]
        for _ in range(cfg.preproc.pyramid_levels - 1):
            p, n = resize_points_normals(mp[-1], mn[-1])
            mp.append(p)
            mn.append(n)

        new_state = DenseState(
            tsdf=vol.tsdf,
            weight=vol.weight,
            color=color,
            T_wc=T_int,
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=torch.where(do_reset, 0, state.frame + 1),
            resets=state.resets + do_reset.to(torch.int32),
        )
        aux = StepAux(
            ok=ok,
            residual=icp.residual,
            num_inliers=icp.num_inliers,
            was_reset=do_reset,
        )
        return new_state, aux

    # ------------------------------------------------------------------
    def _raycast(self, vol: DenseVolume, T_wc: torch.Tensor) -> RaycastResult:
        cfg = self.cfg
        return raycast_dense(vol, cfg.camera, cfg.tsdf, cfg.dense, cfg.raycast, T_wc)

    def render(self, state: DenseState) -> torch.Tensor:
        """Phong-shaded uint8 [H, W, 3] view from the tracked pose, lit
        from above and behind the camera."""
        rc = self._raycast(DenseVolume(*self._whole(state.tsdf, state.weight)), state.T_wc)
        eye = state.T_wc[:3, 3]
        light = eye + vec((0.0, -1.0, -1.0), self.device)
        return phong_shade(rc.points, rc.normals, light, eye)

    def render_color(self, state: DenseState) -> torch.Tensor:
        """Fused-color view from the tracked pose, uint8 [H, W, 3]: the
        color of the voxel nearest each hit (black without a color grid)."""
        cfg = self.cfg
        tsdf, weight, color = self._whole(state.tsdf, state.weight, state.color)
        rc = self._raycast(DenseVolume(tsdf, weight), state.T_wc)
        origin = vec(cfg.dense.origin, self.device)
        pv = true_div(rc.points - origin, cfg.tsdf.voxel_size)
        col = sample_color_dense(color, pv, color.shape[:3])
        col = torch.where(rc.hit[..., None], col, 0.0)
        return (torch.clamp(col, 0.0, 1.0) * 255.0).to(torch.uint8)
