"""Surface point-cloud extraction with normals (port of
``topfusion_tpu/ops/pointcloud.py``): find voxels within one voxel of the
zero crossing, project each onto the surface along the SDF gradient, and
emit fixed-capacity (points, normals, valid) tensors, compacted by
rank and scatter with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import BlockMapConfig, DenseVolumeConfig, TSDFConfig
from ..utils.numerics import norm3
from .blockmap import BlockMap, decode_tsdf, decode_weight, voxel_centers
from .tsdf_dense import DenseVolume, voxel_center_axes


class PointCloud(NamedTuple):
    points: torch.Tensor    # [N, 3] world meters
    normals: torch.Tensor   # [N, 3]
    valid: torch.Tensor     # [N] bool
    count: torch.Tensor     # () int32


def _emit(points, normals, mask, max_points) -> PointCloud:
    """Compact the masked points into ``max_points`` rows, in the order of
    their flat index.  Everything else is written to one extra row, which
    is sliced off."""
    flat_m = mask.reshape(-1)
    rank = torch.cumsum(flat_m.to(torch.int32), dim=0, dtype=torch.int32) - 1
    keep = flat_m & (rank < max_points)
    idx = torch.where(keep, rank, max_points).long()

    def compact(values):
        out = torch.zeros(
            (max_points + 1,) + values.shape[1:], dtype=values.dtype, device=values.device
        )
        out[idx] = values
        return out[:max_points]

    return PointCloud(
        points=compact(points.reshape(-1, 3)),
        normals=compact(normals.reshape(-1, 3)),
        valid=compact(keep),
        count=torch.clamp(torch.sum(flat_m, dtype=torch.int32), max=max_points),
    )


def _surface_from_grid(tsdf, weight, world_pos, mu, voxel):
    """Per-voxel surface test, gradient normal and projection.

    tsdf/weight: [..., X, Y, Z]; world_pos broadcastable [..., X, Y, Z, 3].
    Central differences with wrap-around at the grid's borders.
    """
    def diff(axis):
        a = axis + tsdf.ndim - 3
        return (torch.roll(tsdf, -1, dims=a) - torch.roll(tsdf, 1, dims=a)) * 0.5

    g = torch.stack([diff(0), diff(1), diff(2)], dim=-1)
    gn = norm3(g)
    normal = g / torch.clamp(gn, min=1e-12)[..., None]
    near = (torch.abs(tsdf) * mu < voxel) & (weight > 0.0) & (gn > 1e-6)
    # Project the voxel centre onto the zero level set.
    pts = world_pos - normal * (tsdf * mu)[..., None]
    return pts, normal, near


def extract_pointcloud_dense(
    vol: DenseVolume,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    max_points: int = 1 << 20,
) -> PointCloud:
    """Extract from a dense volume (one pass over the [D0, D1, D2] grid;
    gradients wrap around at its faces)."""
    voxel = tsdf_cfg.voxel_size
    axes = voxel_center_axes(dense_cfg.dims, voxel, dense_cfg.origin, vol.tsdf.device)
    pw = torch.stack(torch.broadcast_tensors(*axes), dim=-1)
    pts, nrm, near = _surface_from_grid(
        vol.tsdf, vol.weight, pw, tsdf_cfg.trunc_dist, voxel
    )
    return _emit(pts, nrm, near, max_points)


def extract_pointcloud_blocks(
    m: BlockMap,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    max_points: int = 1 << 20,
) -> PointCloud:
    """Extract from every live block (one pass over the [C, B, B, B] pool).

    Gradients roll inside a block, so normals at block borders are
    approximate (one-voxel wrap): fine for visualization and export.
    """
    voxel = tsdf_cfg.voxel_size
    pts, nrm, near = _surface_from_grid(
        decode_tsdf(m.tsdf[: m.capacity]),
        decode_weight(m.weight[: m.capacity]),
        voxel_centers(m.block_coords, bm_cfg.block_size, voxel),
        tsdf_cfg.trunc_dist,
        voxel,
    )
    live = torch.arange(m.capacity, device=m.tsdf.device) < m.num_blocks
    live = live[:, None, None, None]
    return _emit(pts, nrm, near & live, max_points)


def save_ply(path: str, pc: PointCloud) -> int:
    """Write valid points+normals as ASCII PLY; returns the point count."""
    v = pc.valid.cpu().numpy()
    rows = np.concatenate([pc.points.cpu().numpy()[v], pc.normals.cpu().numpy()[v]], axis=1)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(rows)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "end_header\n"
        )
        np.savetxt(f, rows, fmt="%.6f %.6f %.6f %.4f %.4f %.4f")
    return len(rows)
