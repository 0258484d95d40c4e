"""The dense-volume pipeline with its grid split over a map axis (port of
``topfusion_tpu/parallel/sharded_pipeline.py``), one process per shard.

The JAX package jits ``DensePipeline._step`` with the volume sharded on
dim 0 and lets GSPMD place the collectives.  Here each process runs the
per-shard program itself:

  * shard r holds the slab ``[r * D / ns, (r + 1) * D / ns)`` of dim 0 of
    ``tsdf``, ``weight`` and (with ``use_color``) ``color``, and
    integrates and resets only those voxels, at their places in the
    whole grid;
  * the raycast that makes the next frame's model maps reads across
    slabs (a nearest-read march, a trilinear refine and SDF normals), so
    the two fields it reads are gathered whole (``all_gather_tiled``) and
    the unchanged ``raycast_dense`` runs on every shard.  The model maps,
    the pose and ICP are then the same on every shard, and a world of one
    is ``DensePipeline``, bit for bit.

The gather moves the whole volume to every shard each frame: each shard
hands ``2 x 4 x D0 x D1 x D2 / ns`` bytes of float32 to it (a 256^3 grid:
128 MiB over the shards).
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..models.pipeline import DensePipeline, DenseState
from ..utils.device_info import entry_device
from .collectives import MapAxis, make_mesh


class ShardedDensePipeline(DensePipeline):
    """``DensePipeline`` over the slab of dim 0 that this member of
    ``axis`` holds; every member calls every method with the same
    arguments.  ``dims[0]`` must divide by the axis size."""

    def __init__(self, cfg: PipelineConfig, axis: MapAxis):
        super().__init__(cfg, axis.device)
        d0, ns = cfg.dense.dims[0], axis.size
        if d0 % ns:
            raise ValueError(f"dims[0] = {d0} does not divide by the {ns} shards")
        self.axis = axis
        self.slab = (axis.rank * d0 // ns, (axis.rank + 1) * d0 // ns)

    def init(self) -> DenseState:
        """This shard's slab of the empty volume (and color grid); pose,
        model maps and counters replicated."""
        s = super().init()
        lo, hi = self.slab
        color = s.color[lo:hi].clone() if self.cfg.tsdf.use_color else s.color
        return s._replace(tsdf=s.tsdf[lo:hi].clone(), weight=s.weight[lo:hi].clone(), color=color)

    def _whole(self, *grids: torch.Tensor) -> tuple:
        """Every shard's slab of each grid, in rank order (the color dummy
        of a volume without color stays as it is)."""
        return tuple(g if g.dim() == 4 and not self.cfg.tsdf.use_color
                     else self.axis.all_gather_tiled(g) for g in grids)


def make_sharded_pipeline(cfg: PipelineConfig, axis: MapAxis | None = None, device="cuda"):
    """``(init, step)`` of the dense pipeline with its grid split over
    ``axis`` (by default the initialized default group, on the card
    unless ``device`` names another): ``init()`` is this shard's state,
    ``step(state, depth_mm, rgb=None)`` one frame."""
    axis = make_mesh(entry_device(device)) if axis is None else axis
    pipe = ShardedDensePipeline(cfg, axis)
    return pipe.init, pipe.step


def dryrun_sharded_step(n_devices: int, axis: MapAxis | None = None, device="cuda") -> None:
    """The sharded dense step at tiny shapes on a world of ``n_devices``
    shards (a grid of ``8 n`` x 64 x 64): the frame-0 bootstrap, then a
    full ICP + integrate + raycast step of the same frame; tracking must
    hold.  Every member of ``axis`` calls it."""
    from ..config import CameraConfig, DenseVolumeConfig, ICPConfig, PreprocConfig, RaycastConfig, TSDFConfig
    from ..io.synthetic import SyntheticScene

    dev = entry_device(device)
    axis = make_mesh(dev) if axis is None else axis
    if axis.size != n_devices:
        raise ValueError(f"need a world of {n_devices} shards, have {axis.size}")
    d = 8 * n_devices
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2)),
        dense=DenseVolumeConfig(dims=(d, 64, 64), origin=(-0.32, -0.32, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.64 / d, trunc_dist=0.04),
        raycast=RaycastConfig(max_steps=48),
    )
    init, step = make_sharded_pipeline(cfg, axis)
    state = init()
    depth = SyntheticScene().render_depth_mm(cam, torch.eye(4, device=dev))
    state, aux = step(state, depth)
    state, aux = step(state, depth)
    if int(state.frame) != 2 or not bool(aux.ok):
        raise RuntimeError(f"the sharded dense step failed a static frame: frame "
                           f"{int(state.frame)}, ok {bool(aux.ok)}")
