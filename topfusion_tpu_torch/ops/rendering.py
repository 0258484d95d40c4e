"""Display rendering: Phong shading, confidence and normal-map coloring
(port of ``topfusion_tpu/ops/rendering.py``).

Images are uint8 after truncation, so a last-bit difference in
``pow`` between the two packages can move a pixel by one grey level and
no more.  Constants are built on the inputs' device from Python numbers
(a host array copied to the card would synchronize).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.numerics import linspace01, norm3, true_div


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(norm3(v)[..., None], min=1e-12)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3, added left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def phong_shade(
    points: torch.Tensor,
    normals: torch.Tensor,
    light_pos: torch.Tensor,
    view_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greyscale Phong shading of a point+normal map -> uint8 [H, W, 3]
    (Ka = 0.3, Kd = 0.5, Ks = 0.2, n = 20); invalid pixels get a vertical
    background gradient."""
    ka, kd, ks, spec_n = 0.3, 0.5, 0.2, 20.0
    valid = torch.any(points != 0.0, dim=-1)

    l_dir = _normalize(light_pos - points)
    v_dir = _normalize(-points if view_pos is None else view_pos - points)
    n = normals
    ndotl = _dot3(n, l_dir)
    r_dir = _normalize(2.0 * n * ndotl[..., None] - l_dir)
    rdotv = torch.clamp(_dot3(r_dir, v_dir), min=0.0)
    intensity = ka + kd * torch.clamp(ndotl, min=0.0) + ks * torch.pow(rdotv, spec_n)
    grey = torch.clamp(intensity, 0.0, 1.0)

    h = points.shape[0]
    wgrad = linspace01(h, points.device)[:, None]               # [h, 1]

    def background(top: float, bottom: float) -> torch.Tensor:
        # float32(c / 255) as a Python number: exact when cast back.
        t = float(np.float32(top) / np.float32(255.0))
        b = float(np.float32(bottom) / np.float32(255.0))
        return t * (1.0 - wgrad) + b * wgrad

    rg = background(2.0, 120.0)
    bg = torch.stack([rg, rg, background(4.0, 236.0)], dim=-1)  # [h, 1, 3]

    rgb = torch.where(valid[..., None], grey[..., None].expand(points.shape), bg)
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_confidence_rgb(
    confidence: torch.Tensor,
    hit: torch.Tensor,
    max_weight: float,
) -> torch.Tensor:
    """Fusion-confidence heatmap -> uint8 [H, W, 3]: green = fully fused
    (weight at ``max_weight``), red = freshly observed, black = miss."""
    c = torch.clamp(true_div(confidence, max_weight), 0.0, 1.0)
    rgb = torch.stack([1.0 - c, c, torch.zeros_like(c)], dim=-1)
    rgb = torch.where(hit[..., None], rgb, 0.0)
    return (rgb * 255.0).to(torch.uint8)


def render_normals_rgb(normals: torch.Tensor) -> torch.Tensor:
    """Normal map -> RGB visualization, (n + 1) / 2 mapping."""
    valid = torch.any(normals != 0.0, dim=-1)
    rgb = torch.clamp((-normals + 1.0) * 0.5, 0.0, 1.0)
    rgb = torch.where(valid[..., None], rgb, 0.0)
    return (rgb * 255.0).to(torch.uint8)
