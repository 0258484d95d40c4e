# Frozen copy of topfusion_tpu_torch/ops/splat.py at commit 81038a6, the yardstick's plain reference.
"""Forward-projection model maps (surfel splatting), single device (port
of ``topfusion_tpu/ops/splat.py``).

  1. visible blocks -> per-voxel surface test (|tsdf|*mu < voxel, w > 0);
  2. per-block top-K surface voxels by one batched sort of packed
     (non_surface | voxel_idx) keys along the voxel axis;
  3. selected voxels move onto the zero level set along the local SDF
     gradient and project into pixels; z-buffering is ONE scatter-min of
     31-bit packed (quantized depth | surfel id) keys, so winners (and
     their tie-breaks) match the JAX package's;
  4. holes close by a separable 3x3 min-dilate of the packed z-buffer;
  5. winner attributes are gathered back; normals come from image-space
     differences of the point map.

On a sharded map (``parallel/block_sharded.py``) every shard splats its
own blocks into a local z-buffer and the winners are composited across
the shards sort-last: one ``pmin`` of the packed keys (surfel ids
interleave the shard id, so keys never tie across shards), then one
``psum`` of the winners' attributes, each pixel's taken from its owner
and zero elsewhere.

Not ported: the JAX package's 8-channel row padding and its
``optimization_barrier`` fences (TPU layout choices) and the pre-gathered
``blocks=`` hand-off (the pool is gathered here).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import BlockMapConfig, CameraConfig, TSDFConfig
from ..geometry.camera import project
from ..geometry.se3 import se3_inverse, transform_points
from .blockmap import BlockMap, decode_tsdf, decode_weight
from .normals import normals_from_point_map
from .tsdf_block import RaycastResult
from ..utils.numerics import true_div

_MAX_DEPTH_BITS = 12   # z quantization of the packed z-buffer key
_MIN_DEPTH_BITS = 6    # floor; at 6 bits z-fighting ties resolve by id
_SENTINEL = 2**31 - 1


def _min_dilate(img: torch.Tensor, fill: int) -> torch.Tensor:
    """3x3 min-stencil that only fills ``fill`` (hole) pixels; separable
    (row-min then column-min of the edge-clamped 3-window)."""

    def axis_min3(a, dim):
        n = a.shape[dim]
        lo = torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim=dim)
        hi = torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim=dim)
        return torch.minimum(a, torch.minimum(lo, hi))

    out = axis_min3(axis_min3(img, 1), 0)
    return torch.where(img != fill, img, out)


def _edge_diff(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Central difference along ``dim``, one-sided at the block faces."""
    n = t.shape[dim]
    fwd = torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)], dim=dim)
    bwd = torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim=dim)
    return (fwd - bwd) * 0.5


def splat_model_maps(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    vis: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    surfels_per_block: int = 128,
    dilate_passes: int = 1,
    axis=None,
) -> RaycastResult:
    """Render point/normal maps from the visible blocks by splatting.

    ``vis`` is the (slots, coords, mask) triple shared with integration;
    ``surfels_per_block`` caps surface voxels taken per block;
    ``dilate_passes`` 3x3 min-dilations close sub-pixel splat holes.
    With ``axis`` (a ``parallel.collectives.MapAxis``) the local splats
    are composited across the axis's shards, and every member returns
    the same maps.
    """
    slots, coords, mask = vis
    bsz = bm_cfg.block_size
    voxel = tsdf_cfg.voxel_size
    mu = tsdf_cfg.trunc_dist
    h, w = cam.height, cam.width
    dev = T_wc.device
    V = slots.shape[0]
    num_shards = 1 if axis is None else axis.size
    nvox = bsz * bsz * bsz
    K = min(surfels_per_block, nvox)
    id_bits = max(1, (V * K * num_shards - 1).bit_length())
    depth_bits = min(_MAX_DEPTH_BITS, 31 - id_bits)
    if depth_bits < _MIN_DEPTH_BITS:
        raise ValueError(
            f"surfel id needs {id_bits} bits; shrink max_visible_blocks or "
            f"surfels_per_block"
        )

    safe_slots = torch.where(mask, slots, 0).long()
    tsdf_blk = decode_tsdf(m.tsdf[safe_slots]).reshape(V, bsz, bsz, bsz)
    w_blk = decode_weight(m.weight[safe_slots]).reshape(V, bsz, bsz, bsz)

    # Surface voxels + gradient (edge-clamped central differences).
    g = torch.stack([_edge_diff(tsdf_blk, d) for d in (1, 2, 3)], dim=-1)
    gn2 = torch.sum(g * g, dim=-1)
    surface = (
        (torch.abs(tsdf_blk) * mu < voxel)
        & (w_blk > 0.0)
        & (gn2 > 1e-12)
        & mask[:, None, None, None]
    )

    # Per-block top-K: sort packed keys (non-surface voxels sort last).
    surf_flat = surface.reshape(V, nvox)
    vox_iota = torch.arange(nvox, dtype=torch.int32, device=dev).expand(V, nvox)
    keys = torch.where(surf_flat, vox_iota, vox_iota + nvox)
    topk = torch.sort(keys, dim=1).values[:, :K]           # [V, K]
    sel_valid = topk < nvox
    sel = torch.where(sel_valid, topk, 0).long()

    t_sel = torch.gather(tsdf_blk.reshape(V, nvox), 1, sel)
    g_sel = torch.gather(g.reshape(V, nvox, 3), 1, sel[..., None].expand(V, K, 3))
    w_sel = torch.gather(w_blk.reshape(V, nvox), 1, sel)
    n_dir = g_sel / torch.clamp(
        torch.linalg.vector_norm(g_sel, dim=-1, keepdim=True), min=1e-12
    )

    # Voxel centre from the in-block index, moved onto the zero crossing.
    lx = torch.div(sel, bsz * bsz, rounding_mode="floor").to(torch.float32)
    ly = torch.remainder(torch.div(sel, bsz, rounding_mode="floor"), bsz).to(torch.float32)
    lz = torch.remainder(sel, bsz).to(torch.float32)
    local = torch.stack([lx, ly, lz], dim=-1)               # [V, K, 3]
    base = coords.to(torch.float32)[:, None, :] * bsz
    centers = (base + local + 0.5) * voxel
    pts = centers - n_dir * (t_sel * mu)[..., None]         # [V, K, 3]

    # Project to the camera.
    pc = transform_points(se3_inverse(T_wc), pts)
    uv, z = project(cam, pc)
    zmin, zmax = tsdf_cfg.view_frustum_min, tsdf_cfg.view_frustum_max
    u = torch.round(uv[..., 0]).to(torch.int32)
    v = torch.round(uv[..., 1]).to(torch.int32)
    ok = (
        sel_valid
        & (z > zmin) & (z < zmax)
        & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    )

    # Packed z-buffer key: quantized depth high, surfel id low; one
    # scatter-min picks the nearest surfel per pixel (ties by id).
    qmax = (1 << depth_bits) - 1
    zq = torch.clamp(true_div(z - zmin, zmax - zmin) * qmax, 0, qmax).to(torch.int32)
    ids = torch.arange(V * K, dtype=torch.int32, device=dev).reshape(V, K)
    if axis is not None:
        # Globally unique surfel ids: the owner is id % num_shards.
        ids = ids * num_shards + axis.rank
    key = (zq << id_bits) | ids

    # Off-image surfels go to one trailing pixel, sliced off after.
    pix = torch.where(ok, v * w + u, h * w).reshape(-1).long()
    zbuf = torch.full((h * w + 1,), _SENTINEL, dtype=torch.int32, device=dev)
    zbuf.scatter_reduce_(0, pix, torch.where(ok, key, _SENTINEL).reshape(-1), "amin")
    zbuf = zbuf[: h * w]
    if axis is not None:
        zbuf = axis.pmin(zbuf)  # the nearest surfel of all shards
    zimg = zbuf.reshape(h, w)
    for _ in range(dilate_passes):
        zimg = _min_dilate(zimg, _SENTINEL)
    zbuf = zimg.reshape(-1)

    hit = zbuf != _SENTINEL
    gid = torch.where(hit, zbuf & ((1 << id_bits) - 1), 0).long()
    surfel_attr = torch.cat(
        [pts.reshape(-1, 3), z.reshape(-1, 1), w_sel.reshape(-1, 1)], dim=-1
    )
    if axis is not None:
        mine = hit & (gid % num_shards == axis.rank)
        won = surfel_attr[torch.where(mine, torch.div(gid, num_shards, rounding_mode="floor"), 0)]
        won = axis.psum(torch.where(mine[:, None], won, 0.0))
    else:
        won = surfel_attr[gid]
    points = torch.where(hit[:, None], won[:, :3], 0.0).reshape(h, w, 3)
    depth = torch.where(hit, won[:, 3], 0.0).reshape(h, w)
    conf = torch.where(hit, won[:, 4], 0.0).reshape(h, w)

    normals = normals_from_point_map(points, T_wc[:3, 3])
    return RaycastResult(
        points=points,
        normals=normals,
        hit=hit.reshape(h, w),
        depth=depth,
        confidence=conf,
    )
