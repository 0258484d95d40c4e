"""Dense fixed-grid TSDF volume (port of ``topfusion_tpu/ops/tsdf_dense.py``):
integration, color fusion, nearest and trilinear reads, SDF normals and
the lockstep raycast, as plain functions on tensors; everything is
computed on the device of the tensors it is given.

The volume is a pair ``tsdf [D0, D1, D2]`` (float32 in [-1, 1]) and
``weight [D0, D1, D2]``, indexed ``tsdf[ix, iy, iz]`` with
``world = origin + (idx + 0.5) * voxel_size``.  The fusion rule and the
march are those of the block-sparse path (``ops/tsdf_block.py``) minus
the sparse indexing:

  eta = depth(project(voxel)) - voxel_camera_z, skipped when eta < -mu
  F <- (F * W + min(1, eta / mu)) / (W + 1);  W <- min(W + 1, maxW)

and the raycast sphere-traces all pixels at once with step
``max(sdf * mu, min_step * voxel)``, nearest-voxel reads while marching
and trilinear reads to refine the crossing.

What differs from the JAX module: the two ``lax.fori_loop``s are Python
loops of fixed length (no step reads a value back to the host, so the
march never ends early), and the ``lax.optimization_barrier`` fences,
which steer XLA's fusion, have no counterpart.  Every float32 expression
keeps the JAX module's order with one rounding per operation, so the
results equal the JAX functions run op by op (under ``jit`` XLA's CPU
backend contracts multiply-adds, which moves them by an ulp or two).
The voxel grid is never materialized as a [D0, D1, D2, 3] tensor: its
three axes stay separate and broadcast, which gives the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import CameraConfig, DenseVolumeConfig, RaycastConfig, TSDFConfig
from ..geometry.camera import pixel_grid, project_xyz
from ..geometry.se3 import rotate_vectors, se3_inverse, transform_xyz
from ..utils.numerics import norm3, true_div, vec
from .normals import normals_from_point_map


class DenseVolume(NamedTuple):
    tsdf: torch.Tensor     # [D0, D1, D2] float32
    weight: torch.Tensor   # [D0, D1, D2] float32


def make_dense_volume(
    cfg: DenseVolumeConfig, dtype=torch.float32, device=None
) -> DenseVolume:
    return DenseVolume(
        tsdf=torch.ones(cfg.dims, dtype=dtype, device=device),  # free space
        weight=torch.zeros(cfg.dims, dtype=dtype, device=device),
    )


def make_color_volume(
    cfg: DenseVolumeConfig, use_color: bool, dtype=torch.float32, device=None
) -> torch.Tensor:
    """RGB color grid [D0, D1, D2, 3], or a 1-voxel dummy when disabled, so
    that the pipeline state keeps its structure."""
    dims = tuple(cfg.dims) if use_color else (1, 1, 1)
    return torch.zeros(dims + (3,), dtype=dtype, device=device)


def voxel_center_axes(dims, voxel: float, origin, device):
    """World coordinates of the voxel centres as three axes
    ``x [D0, 1, 1], y [1, D1, 1], z [1, 1, D2]`` that broadcast to the
    grid: ``idx * voxel + (origin + 0.5 * voxel)``, the offset rounded to
    float32 first, as the JAX package computes it."""
    off = np.asarray(origin, np.float32) + np.float32(0.5 * voxel)
    axes = []
    for a, (d, o) in enumerate(zip(dims, off)):
        shape = [1, 1, 1]
        shape[a] = d
        idx = torch.arange(d, dtype=torch.float32, device=device)
        axes.append((idx * voxel + float(o)).reshape(shape))
    return axes


def _project_voxels(cam, tsdf_cfg, dense_cfg, T_wc, image_shape):
    """Every voxel centre projected into an image of ``image_shape`` =
    (h, w) taken at ``T_wc``: (z, in_bounds, row, column), each
    [D0, D1, D2].  Row and column are clamped into the image (int64, for
    indexing); ``in_bounds`` says whether the rounded pixel was inside it
    and z inside the frustum.  A pixel far off the image converts to
    int32 differently on the CPU and on the card; ``in_bounds`` is false
    for it on both, and callers gate on it."""
    h, w = image_shape
    x, y, z = voxel_center_axes(
        dense_cfg.dims, tsdf_cfg.voxel_size, dense_cfg.origin, T_wc.device
    )
    xc, yc, zc = transform_xyz(se3_inverse(T_wc), x, y, z)
    uf, vf = project_xyz(cam, xc, yc, zc)
    u = torch.round(uf).to(torch.int32)
    v = torch.round(vf).to(torch.int32)
    in_bounds = (
        (u >= 0) & (u < w) & (v >= 0) & (v < h)
        & (zc >= tsdf_cfg.view_frustum_min) & (zc <= tsdf_cfg.view_frustum_max)
    )
    return zc, in_bounds, torch.clamp(v, 0, h - 1).long(), torch.clamp(u, 0, w - 1).long()


def integrate_dense(
    vol: DenseVolume,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
) -> DenseVolume:
    """Fuse one metric depth image [H, W] into the volume at pose ``T_wc``:
    one elementwise pass over all voxels plus a depth gather.  Returns a
    new volume; ``vol`` is not written."""
    mu = tsdf_cfg.trunc_dist
    z, in_bounds, vc, uc = _project_voxels(cam, tsdf_cfg, dense_cfg, T_wc, depth.shape)
    d = depth[vc, uc]

    eta = d - z
    update = in_bounds & (d > 0.0) & (eta >= -mu)
    if tsdf_cfg.stop_integrating_at_max_weight:
        update = update & (vol.weight < tsdf_cfg.max_weight)

    new_f = torch.clamp(torch.clamp(true_div(eta, mu), max=1.0), min=-1.0)
    w_old = vol.weight
    fused = (vol.tsdf * w_old + new_f) / (w_old + 1.0)
    w_new = torch.clamp(w_old + 1.0, max=tsdf_cfg.max_weight)
    return DenseVolume(
        tsdf=torch.where(update, fused, vol.tsdf),
        weight=torch.where(update, w_new, vol.weight),
    )


def integrate_color_dense(
    color_vol: torch.Tensor,
    vol: DenseVolume,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
    rgb: torch.Tensor,
) -> torch.Tensor:
    """Fuse an RGB image [H, W, 3] (uint8, or float in [0, 1]) into the
    color grid: a running average with the weights the depth fusion left
    in ``vol``, taken only by voxels within mu/4 of the observed surface.
    Returns a new grid."""
    mu = tsdf_cfg.trunc_dist
    z, in_bounds, vc, uc = _project_voxels(cam, tsdf_cfg, dense_cfg, T_wc, depth.shape)
    d = depth[vc, uc]
    c_obs = rgb[vc, uc].to(torch.float32)
    if rgb.dtype == torch.uint8:
        c_obs = true_div(c_obs, 255.0)

    eta = d - z
    update = in_bounds & (d > 0.0) & (torch.abs(eta) < mu * 0.25)
    w_old = vol.weight[..., None]
    fused = (color_vol * w_old + c_obs) / (w_old + 1.0)
    return torch.where(update[..., None], fused, color_vol)


# ----------------------------------------------------------------- reads
class _Grid(NamedTuple):
    """A grid's extent as int32 tensors on the device, made once per call
    that reads the grid many times."""

    dims: torch.Tensor      # [3] (D0, D1, D2)
    last: torch.Tensor      # [3] dims - 1
    strides: torch.Tensor   # [3] rows of the flattened grid per step


def _grid(dims, device) -> _Grid:
    hi = vec(dims, device, torch.int32)
    return _Grid(hi, hi - 1, vec((dims[1] * dims[2], dims[2], 1), device, torch.int32))


def _flat_index(idx: torch.Tensor, g: _Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer voxel coords (..., 3) -> (row of the flattened grid with
    the coords clamped into it, in-volume mask).  The mask is taken
    before the clamp: a coordinate beyond int32 (which the CPU and the
    card convert differently) is out of the volume on both."""
    inb = torch.all((idx >= 0) & (idx < g.dims), dim=-1)
    ic = torch.minimum(torch.clamp(idx, min=0), g.last)
    return torch.sum(ic * g.strides, dim=-1), inb


def sample_color_dense(
    color_vol: torch.Tensor, pv: torch.Tensor, dims: Tuple[int, int, int]
) -> torch.Tensor:
    """Nearest-voxel color at fractional voxel coords (..., 3); black
    outside the grid."""
    flat, inb = _flat_index(torch.floor(pv).to(torch.int32), _grid(dims, pv.device))
    c = color_vol.reshape(-1, 3)[flat]
    return torch.where(inb[..., None], c, 0.0)


def _sample_nearest(
    vol: DenseVolume, pv: torch.Tensor, dims: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-voxel (tsdf, weight) at fractional voxel coords pv (..., 3).
    Out-of-volume samples read as free space (tsdf = 1, w = 0)."""
    flat, inb = _flat_index(torch.floor(pv).to(torch.int32), _grid(dims, pv.device))
    t = vol.tsdf.reshape(-1)[flat]
    wt = vol.weight.reshape(-1)[flat]
    return torch.where(inb, t, 1.0), torch.where(inb, wt, 0.0)


def _sample_trilinear(
    vol: DenseVolume, pv: torch.Tensor, dims: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear (tsdf, min-corner-weight) at voxel-centre coords pv.  The
    eight terms are added in the JAX package's order (x outermost) and
    each weight is the product ``(fx * fy) * fz``."""
    p = pv - 0.5  # voxel-centre grid
    base_f = torch.floor(p)
    base = base_f.to(torch.int32)
    frac = p - base_f
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    tsdf = torch.zeros(pv.shape[:-1], dtype=vol.tsdf.dtype, device=pv.device)
    wmin = torch.full_like(tsdf, float("inf"))
    flat_t, flat_w = vol.tsdf.reshape(-1), vol.weight.reshape(-1)
    g = _grid(dims, pv.device)
    i = torch.arange(8, dtype=torch.int32, device=pv.device)
    corners = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], dim=-1)  # x outermost
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                flat, inb = _flat_index(base + corners[4 * cx + 2 * cy + cz], g)
                t = torch.where(inb, flat_t[flat], 1.0)
                wt = torch.where(inb, flat_w[flat], 0.0)
                wgt = (
                    (fx if cx else 1.0 - fx)
                    * (fy if cy else 1.0 - fy)
                    * (fz if cz else 1.0 - fz)
                )
                tsdf = tsdf + wgt * t
                wmin = torch.minimum(wmin, wt)
    return tsdf, wmin


def sdf_normals(
    vol: DenseVolume, pv: torch.Tensor, dims: Tuple[int, int, int]
) -> torch.Tensor:
    """Surface normal from SDF central differences at voxel coords pv,
    with +-0.5-voxel trilinear taps."""
    def tap(offset):
        t, _ = _sample_trilinear(vol, pv + vec(offset, pv.device), dims)
        return t

    gx = tap([0.5, 0.0, 0.0]) - tap([-0.5, 0.0, 0.0])
    gy = tap([0.0, 0.5, 0.0]) - tap([0.0, -0.5, 0.0])
    gz = tap([0.0, 0.0, 0.5]) - tap([0.0, 0.0, -0.5])
    n = torch.stack([gx, gy, gz], dim=-1)
    return n / torch.clamp(norm3(n)[..., None], min=1e-12)


class RaycastResult(NamedTuple):
    points: torch.Tensor    # [H, W, 3] world-space hit points (0 = miss)
    normals: torch.Tensor   # [H, W, 3] world-space normals (0 = miss)
    hit: torch.Tensor       # [H, W] bool
    depth: torch.Tensor     # [H, W] ray depth along camera z (0 = miss)
    # Fusion weight at the hit (the reference's confidence channel).
    confidence: torch.Tensor = None


def raycast_dense(
    vol: DenseVolume,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    ray_cfg: RaycastConfig,
    T_wc: torch.Tensor,
    expected_depth: torch.Tensor | None = None,
    depth_margin: float = 0.16,
    max_steps: int | None = None,
) -> RaycastResult:
    """Sphere-trace every pixel through the volume from pose ``T_wc``, in
    lockstep: all rays take ``max_steps`` steps (``ray_cfg.max_steps`` by
    default) between their entry into and exit from the volume's box,
    finished rays masked out.  ``expected_depth`` (the depth image just
    fused at this pose) narrows each ray to ``+- depth_margin`` around
    it; pixels without valid depth keep the full range."""
    dims = tuple(dense_cfg.dims)
    h, w = cam.height, cam.width
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    dev = T_wc.device
    origin = vec(dense_cfg.origin, dev)

    uv = pixel_grid(cam, device=dev)
    dirs_cam = torch.stack(
        [
            true_div(uv[..., 0] - cam.cx, cam.fx),
            true_div(uv[..., 1] - cam.cy, cam.fy),
            torch.ones((h, w), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    # Stepping t along the ray equals camera-z depth t.
    o_w = T_wc[:3, 3]
    dirs_w = rotate_vectors(T_wc, dirs_cam)

    # Entry and exit of the volume's box, in camera-z units.
    vol_max = origin + vec(dims, dev) * voxel
    safe_d = torch.where(torch.abs(dirs_w) > 1e-12, dirs_w, 1e-12)
    t0 = (origin - o_w) / safe_d
    t1 = (vol_max - o_w) / safe_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_min = torch.clamp(t_near, min=tsdf_cfg.view_frustum_min)
    t_max = torch.clamp(t_far, max=tsdf_cfg.view_frustum_max)
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
    # t advances in camera-z units while the SDF gives metric distance:
    # dividing steps by |dir| keeps the march conservative at the image's
    # periphery.
    dir_norm = norm3(dirs_w)

    def to_voxel(t):
        """Fractional voxel coords of the ray points at ``t``."""
        return true_div(o_w + t[..., None] * dirs_w - origin, voxel)

    flat_t = vol.tsdf.reshape(-1)
    g = _grid(dims, dev)
    t = prev_t = t_min
    prev_sdf = torch.ones((h, w), dtype=torch.float32, device=dev)
    t_hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
    alive = t_min < t_max
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        flat, inb = _flat_index(torch.floor(to_voxel(t)).to(torch.int32), g)
        sdf = torch.where(inb, flat_t[flat], 1.0)
        crossing = alive & (prev_sdf > 0.0) & (sdf <= 0.0)
        # Linear interpolation of the zero crossing between samples.
        diff = prev_sdf - sdf
        denom = torch.where(torch.abs(diff) > 1e-12, diff, 1.0)
        t_cross = prev_t + (t - prev_t) * (prev_sdf / denom)
        t_hit = torch.where(crossing & ~found, t_cross, t_hit)
        found = found | crossing
        step = torch.clamp(sdf * mu, min=min_step) / dir_norm
        t_next = t + step
        alive = alive & ~found & (t_next < t_max)
        prev_sdf, prev_t, t = sdf, t, t_next

    # A few trilinear Newton steps around the crossing.
    for _ in range(ray_cfg.refine_steps):
        sdf_tri, _ = _sample_trilinear(vol, to_voxel(t_hit), dims)
        t_hit = t_hit + sdf_tri * mu / dir_norm

    # Require real data at the hit (weight > 0 on the trilinear support).
    _, w_hit = _sample_trilinear(vol, to_voxel(t_hit), dims)
    hit = found & (w_hit > 0.0) & (t_hit > 0.0)

    p_w = o_w + t_hit[..., None] * dirs_w
    points = torch.where(hit[..., None], p_w, 0.0)
    return RaycastResult(
        points=points,
        # Image-space differences of the point map: projective-TSDF
        # gradients are unreliable on grazing surfaces, the hits are not.
        normals=normals_from_point_map(points, o_w),
        hit=hit,
        depth=torch.where(hit, t_hit, 0.0),
        confidence=torch.where(hit, w_hit, 0.0),
    )
