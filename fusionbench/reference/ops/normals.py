# Frozen copy of topfusion_tpu_torch/ops/normals.py at commit 81038a6, the yardstick's plain reference.
"""Vertex / normal maps and pyramid resizing (port of
``topfusion_tpu/ops/normals.py``).  Invalid entries are exact zeros
(validity == ``|v| > 0``)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..config import CameraConfig
from ..geometry.camera import backproject_grid
from .depth import _shifted


def _unit_normals(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n / max(|n|, 1e-12), |n|) over the last axis."""
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-12), norm[..., 0]


def compute_points_normals(
    cam: CameraConfig, depth: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth [H, W] meters -> (points [H, W, 3], normals [H, W, 3]),
    camera space.

    Normal at (y, x) = normalize(cross(v(y, x+1) - v, v(y+1, x) - v)),
    oriented toward the camera, valid iff all three depths are valid.
    """
    pts = backproject_grid(cam, depth)
    v00 = pts
    v01 = _shifted(pts, 0, 1)
    v10 = _shifted(pts, 1, 0)
    valid = (depth > 0.0) & (_shifted(depth, 0, 1) > 0.0) & (_shifted(depth, 1, 0) > 0.0)

    n, norm = _unit_normals(torch.linalg.cross(v01 - v00, v10 - v00, dim=-1))
    valid = valid & (norm > 1e-12)
    flip = torch.sum(n * v00, dim=-1) > 0.0
    n = torch.where(flip[..., None], -n, n)

    points = torch.where(valid[..., None], v00, 0.0)
    normals = torch.where(valid[..., None], n, 0.0)
    return points, normals


def normals_from_point_map(
    points: torch.Tensor, view_pos: torch.Tensor
) -> torch.Tensor:
    """Normals from image-space finite differences of a (world-space)
    point map [H, W, 3], oriented toward ``view_pos``."""
    valid0 = torch.any(points != 0.0, dim=-1)
    v01 = _shifted(points, 0, 1)
    v10 = _shifted(points, 1, 0)
    valid = valid0 & _shifted(valid0, 0, 1) & _shifted(valid0, 1, 0)
    n, norm = _unit_normals(torch.linalg.cross(v01 - points, v10 - points, dim=-1))
    valid = valid & (norm > 1e-12)
    flip = torch.sum(n * (points - view_pos), dim=-1) > 0.0
    n = torch.where(flip[..., None], -n, n)
    return torch.where(valid[..., None], n, 0.0)


def resize_points_normals(
    points: torch.Tensor, normals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x downsample of point+normal maps: average each 2x2 quad whose
    four points are all valid."""
    h, w = points.shape[:2]
    h2, w2 = h // 2, w // 2

    def quads(img):
        q = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 3)
        return q.permute(0, 2, 1, 3, 4).reshape(h2, w2, 4, 3)

    pq = quads(points)
    nq = quads(normals)
    valid = torch.all(torch.any(pq != 0.0, dim=-1), dim=-1)

    p = torch.mean(pq, dim=2)
    n, _ = _unit_normals(torch.mean(nq, dim=2))

    p = torch.where(valid[..., None], p, 0.0)
    n = torch.where(valid[..., None], n, 0.0)
    return p, n


def build_maps_pyramid(
    cam: CameraConfig, depth_pyr: List[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-level vertex+normal maps from a depth pyramid."""
    points_pyr, normals_pyr = [], []
    for level, depth in enumerate(depth_pyr):
        p, n = compute_points_normals(cam.at_level(level), depth)
        points_pyr.append(p)
        normals_pyr.append(n)
    return points_pyr, normals_pyr
