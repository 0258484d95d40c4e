"""Dense-volume module of the port.  Only ``RaycastResult`` is here so
far: the splat model maps and the hashed-map raycast return it.  The
dense volume itself (``topfusion_tpu/ops/tsdf_dense.py``) is not ported
yet."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RaycastResult(NamedTuple):
    points: torch.Tensor    # [H, W, 3] world-space hit points (0 = miss)
    normals: torch.Tensor   # [H, W, 3] world-space normals (0 = miss)
    hit: torch.Tensor       # [H, W] bool
    depth: torch.Tensor     # [H, W] ray depth along camera z (0 = miss)
    # Fusion weight at the hit (the reference's confidence channel).
    confidence: torch.Tensor = None
