"""Block-sparse TSDF, main-path part (port of
``topfusion_tpu/ops/tsdf_block.py``): allocation from depth, the visible
set (full scan and aged), and the plain gather/fuse/scatter integration
that the CUDA kernel (``ops/cuda/integrate.py``) is held against.

Constants that the JAX package computes in float32 from Python floats
(the block radius, the frustum bounds widened by it, the allocation
fractions) are computed here in numpy float32 the same way, so both
packages compare against the same float32 values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import BlockMapConfig, CameraConfig, TSDFConfig
from ..geometry.camera import pixel_grid, project
from ..geometry.se3 import se3_inverse, transform_points
from .blockmap import (
    BlockMap,
    allocate,
    decode_tsdf,
    decode_weight,
    encode_tsdf,
    encode_weight,
)
from ..utils.numerics import true_div


def _block_radius(tsdf_cfg: TSDFConfig, bm_cfg: BlockMapConfig) -> float:
    """float32(0.5 * sqrt(3) * block_metric), as a Python float."""
    block_metric = np.float32(bm_cfg.block_size * tsdf_cfg.voxel_size)
    return float(np.float32(0.5) * np.sqrt(np.float32(3.0)) * block_metric)


def _linspace01(k: int, device) -> torch.Tensor:
    """The float32 values the JAX package's ``jnp.linspace(0, 1, k)``
    takes: ``i * float32(1/(k-1))`` for i < k-1 (XLA multiplies by the
    reciprocal), then exactly 1.  ``torch.linspace`` and a true division
    are each an ulp off for some k (4 and 7).  Built on the device, since
    copying a host array there would synchronize."""
    one = torch.ones(1, dtype=torch.float32, device=device)
    if k == 1:
        return one * 0.0
    i = torch.arange(k - 1, dtype=torch.float32, device=device)
    return torch.cat([i * (1.0 / (k - 1)), one])


# ----------------------------------------------------------------- alloc
def allocate_from_depth(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
    return_touched: bool = False,
):
    """Mark-and-insert blocks intersecting the depth+-mu band.

    For each (strided) valid pixel, ``alloc_steps`` points along the
    camera ray between ``(1 - mu/|p|)`` and ``(1 + mu/|p|)`` of the
    backprojected point become allocation candidates.
    """
    stride = bm_cfg.alloc_pixel_stride
    k = bm_cfg.alloc_steps
    mu = tsdf_cfg.trunc_dist
    block_metric = bm_cfg.block_size * tsdf_cfg.voxel_size

    h0, w0 = depth.shape
    hs, ws = h0 // stride, w0 // stride
    d = depth[: hs * stride : stride, : ws * stride : stride]
    uv = pixel_grid(cam, device=depth.device)[::stride, ::stride]
    valid = (d > 0.0) & (d >= tsdf_cfg.view_frustum_min) & (d <= tsdf_cfg.view_frustum_max)

    x = true_div(uv[..., 0] - cam.cx, cam.fx)
    y = true_div(uv[..., 1] - cam.cy, cam.fy)
    ones = torch.ones_like(x)
    ray = torch.stack([x, y, ones], dim=-1)
    norm = torch.sqrt(x * x + y * y + ones * ones)
    rel = true_div(mu, torch.clamp(d * norm, min=1e-6))
    lam0 = d * (1.0 - rel)
    lam1 = d * (1.0 + rel)

    fracs = _linspace01(k, depth.device)
    lam = lam0[..., None] + (lam1 - lam0)[..., None] * fracs  # [h, w, k]
    pts_cam = ray[..., None, :] * lam[..., None]              # [h, w, k, 3]
    pts_w = transform_points(T_wc, pts_cam)
    coords = torch.floor(true_div(pts_w, block_metric)).to(torch.int32)

    cand = coords.reshape(-1, 3)
    cand_valid = valid[..., None].expand(lam.shape).reshape(-1)
    return allocate(m, cand, cand_valid, bm_cfg, return_touched=return_touched)


# ----------------------------------------------------------------- visibility
def _project_block_centers(coords, cam, tsdf_cfg, bm_cfg, T_wc):
    block_metric = bm_cfg.block_size * tsdf_cfg.voxel_size
    centers_w = (coords.to(torch.float32) + 0.5) * block_metric
    centers_cam = transform_points(se3_inverse(T_wc), centers_w)
    return project(cam, centers_cam)


def _block_frustum_mask(
    coords: torch.Tensor,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
) -> torch.Tensor:
    """Conservative block-bounding-sphere frustum test over block coords
    [..., 3]."""
    radius = _block_radius(tsdf_cfg, bm_cfg)
    uv, z = _project_block_centers(coords, cam, tsdf_cfg, bm_cfg, T_wc)
    zs = torch.clamp(z, min=tsdf_cfg.view_frustum_min * 0.5)
    # |f|: the margin is a pixel radius, sign-free (fy < 0 conventions).
    ru = true_div(radius, zs) * abs(cam.fx)
    rv = true_div(radius, zs) * abs(cam.fy)
    z_lo = float(np.float32(tsdf_cfg.view_frustum_min) - np.float32(radius))
    z_hi = float(np.float32(tsdf_cfg.view_frustum_max) + np.float32(radius))
    return (
        (z > z_lo)
        & (z < z_hi)
        & (uv[..., 0] >= -ru)
        & (uv[..., 0] <= cam.width - 1 + ru)
        & (uv[..., 1] >= -rv)
        & (uv[..., 1] <= cam.height - 1 + rv)
    )


def _block_occlusion_mask(
    coords: torch.Tensor,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
) -> torch.Tensor:
    """True = the block is potentially OBSERVABLE from this frame: its
    nearest point is not beyond every valid depth sample (+mu) in its
    footprint.  Culling the others is exact for integration (the fusion
    rule skips ``eta < -mu``) and conservative for splatting.  The
    footprint bound is a 16x16 max-pool of the depth dilated by a 3x3
    tile neighbourhood.
    """
    t = 16
    h, w = depth.shape
    radius = _block_radius(tsdf_cfg, bm_cfg)
    uv, z = _project_block_centers(coords, cam, tsdf_cfg, bm_cfg, T_wc)

    ht, wt = -(-h // t), -(-w // t)
    d_full = torch.nn.functional.pad(depth, (0, wt * t - w, 0, ht * t - h))
    d_tile = torch.amax(d_full.reshape(ht, t, wt, t), dim=(1, 3))
    d_pad = torch.nn.functional.pad(d_tile, (1, 1, 1, 1))
    d_max = d_tile
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d_max = torch.maximum(
                d_max, d_pad[1 + dy : 1 + dy + ht, 1 + dx : 1 + dx + wt]
            )

    # The float->int conversion of an off-image centre differs between
    # the CPU and the card; the frustum mask, ANDed with this one by
    # every caller, rejects those blocks either way.
    ut = torch.clamp(true_div(uv[..., 0], t).to(torch.int32), 0, wt - 1)
    vt = torch.clamp(true_div(uv[..., 1], t).to(torch.int32), 0, ht - 1)
    d_near = d_max[vt.long(), ut.long()]
    return z - radius <= d_near + tsdf_cfg.trunc_dist


def _compact_visible(
    m: BlockMap, vis: torch.Tensor, cand_slots: torch.Tensor, v_max: int,
    return_overflow: bool,
):
    """Compact candidates with ``vis`` set into [v_max] (slots, coords,
    mask), in candidate order."""
    rank = torch.cumsum(vis.to(torch.int32), dim=0, dtype=torch.int32) - 1
    keep = vis & (rank < v_max)
    idx = torch.where(keep, rank, v_max).long()
    slots = torch.full((v_max + 1,), -1, dtype=torch.int32, device=vis.device)
    slots[idx] = torch.where(keep, cand_slots, -1)
    slots = slots[:v_max]
    mask = slots >= 0
    coords = m.block_coords[torch.where(mask, slots, 0).long()]
    if return_overflow:
        overflow = torch.clamp(torch.sum(vis, dtype=torch.int32) - v_max, min=0)
        return slots, coords, mask, overflow
    return slots, coords, mask


def visible_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    return_overflow: bool = False,
    depth: torch.Tensor | None = None,
):
    """Frustum-visible live blocks by a FULL scan of the pool.

    Returns (slots [V_max], coords [V_max, 3], mask [V_max]); with
    ``return_overflow`` also the count of visible live blocks truncated
    by the ``max_visible_blocks`` bound.  With ``depth``, blocks the
    observed depth occludes are culled.
    """
    live = torch.arange(m.capacity, device=T_wc.device) < m.num_blocks
    vis = live & _block_frustum_mask(m.block_coords, cam, tsdf_cfg, bm_cfg, T_wc)
    if depth is not None:
        vis = vis & _block_occlusion_mask(
            m.block_coords, cam, tsdf_cfg, bm_cfg, T_wc, depth
        )
    all_slots = torch.arange(m.capacity, dtype=torch.int32, device=T_wc.device)
    return _compact_visible(
        m, vis, all_slots, bm_cfg.max_visible_blocks, return_overflow
    )


def visible_blocks_incremental(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    prev_slots: torch.Tensor,     # [V_max] int32, -1 = empty
    touched_slots: torch.Tensor,  # [t_max] int32, -1 = empty
    return_overflow: bool = False,
    depth: torch.Tensor | None = None,
):
    """Visible set by AGING: re-check only last frame's visible blocks
    plus this frame's allocation-touched blocks.  Same outputs as
    :func:`visible_blocks`."""
    cand = torch.cat([prev_slots, touched_slots])
    imax = 2**31 - 1
    key = torch.where(cand >= 0, cand, imax)
    s = torch.sort(key).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    uniq = first & (s != imax) & (s < m.num_blocks)
    coords_u = m.block_coords[torch.where(uniq, s, 0).long()]
    vis = uniq & _block_frustum_mask(coords_u, cam, tsdf_cfg, bm_cfg, T_wc)
    if depth is not None:
        vis = vis & _block_occlusion_mask(
            coords_u, cam, tsdf_cfg, bm_cfg, T_wc, depth
        )
    return _compact_visible(
        m, vis, s, bm_cfg.max_visible_blocks, return_overflow
    )


# ----------------------------------------------------------------- integrate
def integrate_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
    vis: Tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[BlockMap, torch.Tensor]:
    """Fuse one depth image into the visible blocks; plain PyTorch.

    Gather visible blocks -> one elementwise pass over [V, B, B, B]
    voxels (the rule of computeUpdatedVoxelDepthInfo: update iff the
    voxel projects into the image and frustum, ``d > 0`` and
    ``eta = d - z >= -mu``; ``tsdf' = (tsdf*w + clamp(eta/mu))/(w+1)``,
    ``w' = min(w+1, max_weight)``) -> scatter back.

    The pool is updated IN PLACE (``m.tsdf`` / ``m.weight`` are written),
    as the CUDA kernel does; callers that need the old pool clone it.
    Padded entries gather and scatter the sacrificial row.  Returns
    (map, num_visible).
    """
    if vis is None:
        vis = visible_blocks(m, cam, tsdf_cfg, bm_cfg, T_wc)
    slots, coords, mask = vis
    bsz = bm_cfg.block_size
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    h, w = depth.shape
    dev = depth.device

    safe_slots = torch.where(mask, slots, m.capacity).long()
    tsdf_blk = decode_tsdf(m.tsdf[safe_slots])          # [V, B, B, B]
    w_blk = decode_weight(m.weight[safe_slots])

    # World position of every voxel centre; voxel (x, y, z) of a block
    # sits at pool offset x*B*B + y*B + z.
    ar = torch.arange(bsz, dtype=torch.float32, device=dev)
    lx = ar.view(1, bsz, 1, 1).expand(1, bsz, bsz, bsz)
    ly = ar.view(1, 1, bsz, 1).expand(1, bsz, bsz, bsz)
    lz = ar.view(1, 1, 1, bsz).expand(1, bsz, bsz, bsz)
    local = torch.stack([lx, ly, lz], dim=-1)                     # [1,B,B,B,3]
    base = coords.to(torch.float32)[:, None, None, None, :] * bsz
    pw = (base + local + 0.5) * voxel

    T_cw = se3_inverse(T_wc)
    pc = transform_points(T_cw, pw)
    uv, z = project(cam, pc)
    u = torch.round(uv[..., 0]).to(torch.int32)
    v = torch.round(uv[..., 1]).to(torch.int32)
    in_bounds = (
        (u >= 0) & (u < w) & (v >= 0) & (v < h)
        & (z >= tsdf_cfg.view_frustum_min) & (z <= tsdf_cfg.view_frustum_max)
    )
    uc = torch.clamp(u, 0, w - 1).long()
    vc = torch.clamp(v, 0, h - 1).long()
    d = depth[vc, uc]

    eta = d - z
    update = in_bounds & (d > 0.0) & (eta >= -mu) & mask[:, None, None, None]
    if tsdf_cfg.stop_integrating_at_max_weight:
        update = update & (w_blk < tsdf_cfg.max_weight)

    new_f = torch.clamp(torch.clamp(true_div(eta, mu), max=1.0), min=-1.0)
    fused = (tsdf_blk * w_blk + new_f) / (w_blk + 1.0)
    w_new = torch.clamp(w_blk + 1.0, max=tsdf_cfg.max_weight)

    tsdf_out = torch.where(update, fused, tsdf_blk)
    w_out = torch.where(update, w_new, w_blk)

    m.tsdf[safe_slots] = encode_tsdf(tsdf_out, m.tsdf.dtype)
    m.weight[safe_slots] = encode_weight(w_out, m.weight.dtype)
    return m, torch.sum(mask, dtype=torch.int32)
