# Frozen copy of topfusion_tpu_torch/geometry/camera.py at commit 81038a6, the yardstick's plain reference.
"""Pinhole camera projection / backprojection (port of
``topfusion_tpu/geometry/camera.py``).

Op order is kept as in the JAX package (``x / z * fx + cx``): the CUDA
integrate kernel projects voxels with the same expression.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import CameraConfig
from ..utils.numerics import true_div


def intrinsics_matrix(cam: CameraConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    """The 3x3 pinhole matrix [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device,
    )


def project(
    cam: CameraConfig, points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points (...,3) -> pixel coords (...,2) [u, v] and depth z.

    No validity handling here — callers gate on z > 0 and bounds.
    """
    z = points[..., 2]
    u, v = project_xyz(cam, points[..., 0], points[..., 1], z)
    return torch.stack([u, v], dim=-1), z


def project_xyz(cam: CameraConfig, x, y, z) -> Tuple[torch.Tensor, torch.Tensor]:
    """``project`` on separate coordinate tensors: pixel coords (u, v)."""
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    return x / safe_z * cam.fx + cam.cx, y / safe_z * cam.fy + cam.cy


def backproject(
    cam: CameraConfig, uv: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """Pixel coords (...,2) + depth (...) -> camera-space points (...,3)."""
    x = true_div(uv[..., 0] - cam.cx, cam.fx) * depth
    y = true_div(uv[..., 1] - cam.cy, cam.fy) * depth
    return torch.stack([x, y, depth], dim=-1)


def pixel_grid(
    cam: CameraConfig, dtype=torch.float32, device=None
) -> torch.Tensor:
    """[H, W, 2] grid of (u, v) pixel-centre coordinates."""
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=dtype, device=device),
        torch.arange(cam.width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([u, v], dim=-1)


def backproject_grid(cam: CameraConfig, depth: torch.Tensor) -> torch.Tensor:
    """Depth image [H, W] (meters; 0 = invalid) -> vertex map [H, W, 3].

    Invalid depths produce the zero point (validity == z > 0).
    """
    uv = pixel_grid(cam, dtype=depth.dtype, device=depth.device)
    pts = backproject(cam, uv, depth)
    valid = depth > 0.0
    return torch.where(valid[..., None], pts, torch.zeros_like(pts))
