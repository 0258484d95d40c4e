# Frozen copy of topfusion_tpu_torch/ops/tsdf_block.py at commit 81038a6, the yardstick's plain reference,
# with RaycastResult from ops/tsdf_dense.py (the dense volume left out) and without the
# free-view renders' expected-depth ranges.
"""Block-sparse TSDF (port of ``topfusion_tpu/ops/tsdf_block.py``):
allocation from depth (ownership-filtered on a sharded map, with the
candidate pass split over pixel rows), the visible set (full scan and aged), the plain
gather/fuse/scatter integration that the CUDA kernel
(``ops/cuda/integrate.py``) is held against, color fusion and the lockstep
raycast through the hashed map (shard-local on
a sharded map).

Constants that the JAX package computes in float32 from Python floats
(the block radius, the frustum bounds widened by it, the allocation
fractions) are computed here in numpy float32 the same way, so both
packages compare against the same float32 values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import BlockMapConfig, CameraConfig, RaycastConfig, TSDFConfig
from ..geometry.camera import pixel_grid, project
from ..geometry.se3 import rotate_vectors, se3_inverse, transform_points
from ..utils.numerics import linspace01, norm3, true_div
from .blockmap import (
    BlockMap,
    allocate,
    decode_tsdf,
    decode_weight,
    encode_tsdf,
    encode_weight,
    read_voxels_nearest,
    sample_trilinear,
    voxel_centers,
)
from .normals import normals_from_point_map


class RaycastResult(NamedTuple):
    points: torch.Tensor    # [H, W, 3] world-space hit points (0 = miss)
    normals: torch.Tensor   # [H, W, 3] world-space normals (0 = miss)
    hit: torch.Tensor       # [H, W] bool
    depth: torch.Tensor     # [H, W] ray depth along camera z (0 = miss)
    # Fusion weight at the hit (the reference's confidence channel).
    confidence: torch.Tensor = None


def _block_radius(tsdf_cfg: TSDFConfig, bm_cfg: BlockMapConfig) -> float:
    """float32(0.5 * sqrt(3) * block_metric), as a Python float."""
    block_metric = np.float32(bm_cfg.block_size * tsdf_cfg.voxel_size)
    return float(np.float32(0.5) * np.sqrt(np.float32(3.0)) * block_metric)


# ----------------------------------------------------------------- alloc
def allocate_from_depth(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
    shard=None,
    return_touched: bool = False,
    row_shard=None,
):
    """Mark-and-insert blocks intersecting the depth+-mu band.

    For each (strided) valid pixel, ``alloc_steps`` points along the
    camera ray between ``(1 - mu/|p|)`` and ``(1 + mu/|p|)`` of the
    backprojected point become allocation candidates.

    ``shard = (shard_id, num_shards)`` inserts only the candidates this
    shard owns.  ``row_shard`` (a ``parallel.collectives.MapAxis``)
    splits the candidate pass: each member takes its strip of
    ``h // size`` strided rows (rows past ``size * (h // size)`` are
    dropped, as in the JAX package) and the strips' fixed-size candidate
    lists are gathered, so that every member inserts from the whole set.
    """
    stride = bm_cfg.alloc_pixel_stride
    k = bm_cfg.alloc_steps
    mu = tsdf_cfg.trunc_dist
    block_metric = bm_cfg.block_size * tsdf_cfg.voxel_size

    h0, w0 = depth.shape
    hs, ws = h0 // stride, w0 // stride
    d = depth[: hs * stride : stride, : ws * stride : stride]
    uv = pixel_grid(cam, device=depth.device)[::stride, ::stride]
    if row_shard is not None:
        hl = d.shape[0] // row_shard.size
        d = d[row_shard.rank * hl : (row_shard.rank + 1) * hl]
        uv = uv[row_shard.rank * hl : (row_shard.rank + 1) * hl]
    valid = (d > 0.0) & (d >= tsdf_cfg.view_frustum_min) & (d <= tsdf_cfg.view_frustum_max)

    x = true_div(uv[..., 0] - cam.cx, cam.fx)
    y = true_div(uv[..., 1] - cam.cy, cam.fy)
    ones = torch.ones_like(x)
    ray = torch.stack([x, y, ones], dim=-1)
    norm = torch.sqrt(x * x + y * y + ones * ones)
    rel = true_div(mu, torch.clamp(d * norm, min=1e-6))
    lam0 = d * (1.0 - rel)
    lam1 = d * (1.0 + rel)

    fracs = linspace01(k, depth.device)
    lam = lam0[..., None] + (lam1 - lam0)[..., None] * fracs  # [h, w, k]
    pts_cam = ray[..., None, :] * lam[..., None]              # [h, w, k, 3]
    pts_w = transform_points(T_wc, pts_cam)
    coords = torch.floor(true_div(pts_w, block_metric)).to(torch.int32)

    cand = coords.reshape(-1, 3)
    cand_valid = valid[..., None].expand(lam.shape).reshape(-1)
    if row_shard is not None:
        cand = row_shard.all_gather_tiled(cand)
        cand_valid = row_shard.all_gather_tiled(cand_valid)
    return allocate(
        m, cand, cand_valid, bm_cfg, shard=shard, return_touched=return_touched
    )


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
def _project_block_voxels(coords, cam, tsdf_cfg, bm_cfg, T_wc, image_shape):
    """Every voxel centre of blocks ``coords`` [V, 3] projected into an
    image of ``image_shape`` = (h, w) taken by the camera at ``T_wc``:
    (z, in_bounds, row, column), each [V, B, B, B];
    row and column are clamped into the image (int64, for indexing) and
    ``in_bounds`` says whether the rounded pixel was inside it and z
    inside the frustum."""
    h, w = image_shape
    pw = voxel_centers(coords, bm_cfg.block_size, tsdf_cfg.voxel_size)
    pc = transform_points(se3_inverse(T_wc), pw)
    uv, z = project(cam, pc)
    u = torch.round(uv[..., 0]).to(torch.int32)
    v = torch.round(uv[..., 1]).to(torch.int32)
    in_bounds = (
        (u >= 0) & (u < w) & (v >= 0) & (v < h)
        & (z >= tsdf_cfg.view_frustum_min) & (z <= tsdf_cfg.view_frustum_max)
    )
    return z, in_bounds, torch.clamp(v, 0, h - 1).long(), torch.clamp(u, 0, w - 1).long()


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
    mu = tsdf_cfg.trunc_dist

    safe_slots = torch.where(mask, slots, m.capacity).long()
    tsdf_blk = decode_tsdf(m.tsdf[safe_slots])          # [V, B, B, B]
    w_blk = decode_weight(m.weight[safe_slots])

    z, in_bounds, vc, uc = _project_block_voxels(
        coords, cam, tsdf_cfg, bm_cfg, T_wc, depth.shape
    )
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


# ----------------------------------------------------------------- color
def integrate_color_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
    rgb: torch.Tensor,
    vis: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> BlockMap:
    """Fuse an RGB image [H, W, 3] (uint8, or float in [0, 1]) into the
    visible blocks' color pool: a running average with the fusion weights,
    taken only by voxels within mu/4 of the observed surface.  A separate
    gather/fuse/scatter pass after the depth integrator, which stays
    color-agnostic; it reads the weights that pass left behind.

    The color pool is updated IN PLACE, like the TSDF pool.  Padded
    entries gather row 0 and scatter the sacrificial row, as in the JAX
    package.
    """
    slots, coords, mask = vis
    mu = tsdf_cfg.trunc_dist

    safe_slots = torch.where(mask, slots, 0).long()
    w_blk = decode_weight(m.weight[safe_slots])[..., None]
    c_blk = decode_tsdf(m.color[safe_slots])            # [V, B, B, B, 3]

    z, in_bounds, vc, uc = _project_block_voxels(
        coords, cam, tsdf_cfg, bm_cfg, T_wc, depth.shape
    )
    d = depth[vc, uc]
    c_obs = rgb[vc, uc].to(torch.float32)
    if rgb.dtype == torch.uint8:
        c_obs = true_div(c_obs, 255.0)

    eta = d - z
    update = (
        in_bounds & (d > 0.0) & (torch.abs(eta) < mu * 0.25)
        & mask[:, None, None, None]
    )
    fused = (c_blk * w_blk + c_obs) / (w_blk + 1.0)
    c_out = torch.where(update[..., None], fused, c_blk)

    scatter_slots = torch.where(mask, slots, m.capacity).long()
    m.color[scatter_slots] = encode_tsdf(c_out, m.color.dtype)
    return m


# ----------------------------------------------------------------- raycast
def raycast_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    ray_cfg: RaycastConfig,
    T_wc: torch.Tensor,
    expected_depth: torch.Tensor | None = None,
    depth_margin: float = 0.16,
    max_steps: int | None = None,
    shard=None,
    weight_gate: str = "trilinear",
    range_image: torch.Tensor | None = None,
    range_subsample: int | None = None,
) -> RaycastResult:
    """Sphere-trace every pixel through the sparse map, in lockstep: all
    rays take ``max_steps`` steps (``ray_cfg.max_steps`` by default), each
    one block lookup; a miss advances a full block width.  No step reads
    a value back to the host, so the march never ends early.

    ``expected_depth`` (the depth image just fused at this pose) starts
    each ray at ``expected_depth - depth_margin`` and stops it at
    ``+ depth_margin``; pixels without valid depth keep the full range.
    ``range_image`` is the free-view analogue, a (zmin, zmax) image:
    rays start at their cell's zmin and die past zmax, so a small
    ``max_steps`` covers the occupied band.
    ``weight_gate="nearest"`` accepts a hit on the nearest voxel's weight
    instead of the trilinear stencil's minimum.  ``shard`` marches this
    shard's blocks alone (remote space reads as free); a sharded map
    gates on the nearest voxel, since the trilinear stencil straddles
    block borders and a remote neighbour would read weight 0.
    """
    h, w = cam.height, cam.width
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    bits = bm_cfg.coord_bits
    block_metric = bm_cfg.block_size * voxel
    dev = T_wc.device

    uv = pixel_grid(cam, device=dev)
    dirs_cam = torch.stack(
        [
            true_div(uv[..., 0] - cam.cx, cam.fx),
            true_div(uv[..., 1] - cam.cy, cam.fy),
            torch.ones((h, w), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    o_w = T_wc[:3, 3]
    dirs_w = rotate_vectors(T_wc, dirs_cam)
    dir_norm = norm3(dirs_w)

    t_min = torch.full((h, w), tsdf_cfg.view_frustum_min, dtype=torch.float32, device=dev)
    t_max = torch.full((h, w), tsdf_cfg.view_frustum_max, dtype=torch.float32, device=dev)
    if range_image is not None:
        sub = range_subsample or ray_cfg.range_subsample
        ch, cw = range_image.shape[:2]
        full = range_image[:, None, :, None, :].expand(ch, sub, cw, sub, 2)
        full = full.reshape(ch * sub, cw * sub, 2)[:h, :w]
        # One-voxel slack: trilinear refinement may probe just outside
        # the corner-derived bounds.
        t_min = torch.maximum(t_min, full[..., 0] - voxel)
        t_max = torch.minimum(t_max, full[..., 1] + voxel)
        # Empty cells carry zlo > zhi: pin them to a band that is dead at
        # once, with finite arithmetic.
        t_min = torch.minimum(t_min, t_max)
    if expected_depth is not None:
        dvalid = expected_depth > 0.0
        t_min = torch.where(
            dvalid, torch.maximum(t_min, expected_depth - depth_margin), t_min
        )
        t_max = torch.where(
            dvalid, torch.minimum(t_max, expected_depth + depth_margin), t_max
        )
    n_steps = max_steps if max_steps is not None else ray_cfg.max_steps
    min_step = ray_cfg.min_step_voxels * voxel

    def to_voxel(t):
        """Fractional global voxel coords of the ray points at ``t``."""
        return true_div(o_w + t[..., None] * dirs_w, voxel)

    t = prev_t = t_min
    prev_sdf = torch.ones((h, w), dtype=torch.float32, device=dev)
    t_hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
    alive = torch.ones((h, w), dtype=torch.bool, device=dev)
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        vox = torch.floor(to_voxel(t)).to(torch.int32)
        sdf, _wt, blk_found = read_voxels_nearest(m, vox, bits, shard=shard)
        crossing = alive & blk_found & (prev_sdf > 0.0) & (sdf <= 0.0)
        diff = prev_sdf - sdf
        denom = torch.where(torch.abs(diff) > 1e-12, diff, 1.0)
        t_cross = prev_t + (t - prev_t) * (prev_sdf / denom)
        t_hit = torch.where(crossing & ~found, t_cross, t_hit)
        found = found | crossing
        # Miss -> skip a block width; hit -> sphere step on the sampled sdf.
        step = torch.where(
            blk_found, torch.clamp(sdf * mu, min=min_step), block_metric
        ) / dir_norm
        t_next = t + step
        alive = alive & ~found & (t_next < t_max)
        # prev_sdf only means something inside allocated space: entering a
        # block from unallocated space starts a fresh sign history.
        prev_sdf = torch.where(blk_found, sdf, 1.0)
        prev_t, t = t, t_next

    for _ in range(ray_cfg.refine_steps):
        sdf_tri, _ = sample_trilinear(m, to_voxel(t_hit), bits, shard=shard)
        t_hit = t_hit + sdf_tri * mu / dir_norm

    if weight_gate == "nearest":
        vox_hit = torch.floor(to_voxel(t_hit)).to(torch.int32)
        _, w_hit, _ = read_voxels_nearest(m, vox_hit, bits, shard=shard)
    else:
        _, w_hit = sample_trilinear(m, to_voxel(t_hit), bits, shard=shard)
    hit = found & (w_hit > 0.0) & (t_hit > 0.0)

    p_w = o_w + t_hit[..., None] * dirs_w
    points = torch.where(hit[..., None], p_w, 0.0)
    return RaycastResult(
        points=points,
        normals=normals_from_point_map(points, o_w),
        hit=hit,
        depth=torch.where(hit, t_hit, 0.0),
        confidence=torch.where(hit, w_hit, 0.0),
    )
