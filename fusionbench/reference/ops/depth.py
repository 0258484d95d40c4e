# Frozen copy of topfusion_tpu_torch/ops/depth.py at commit 81038a6, the yardstick's plain reference.
"""Depth-image preprocessing (port of ``topfusion_tpu/ops/depth.py``).

Whole-image tensor expressions: each stencil is a static sum of shifted
images.  Depth is float32 METERS past the sensor boundary, ``0.0`` means
invalid.  Both edge semantics come along: the default excludes invalid
neighbours from the support; ``reference_edge_semantics`` reproduces the
original engine's positional window (invalid zeros participate).

Not ported: the JAX package's stage-boundary ``optimization_barrier``
fences (an XLA fusion concern; eager PyTorch materializes every stage)
and its parity-reshape decimation, which here is a plain strided slice
with the same values.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..config import PreprocConfig


def depth_to_meters(
    depth_mm: torch.Tensor, max_sensor_depth: float = 2.046
) -> torch.Tensor:
    """u16/int millimeter depth -> float32 meters; invalid -> 0
    (0 or >= 2047 mm invalid)."""
    d = depth_mm.to(torch.float32) * 0.001
    valid = (d > 0.0) & (d < max_sensor_depth)
    return torch.where(valid, d, 0.0)


def _shifted(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """Image shifted so that out[y, x] = img[y+dy, x+dx]; out-of-bounds = fill.

    ``img`` is [H, W] or [H, W, C].
    """
    h, w = img.shape[:2]
    trail = img.ndim - 2
    # F.pad pads the last dims first: (C pads...), then W, then H.
    pad = [0, 0] * trail + [max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)]
    if img.dtype == torch.bool:
        padded = F.pad(img.to(torch.uint8), pad, value=int(fill)).to(torch.bool)
    else:
        padded = F.pad(img, pad, value=fill)
    return padded[max(dy, 0) : max(dy, 0) + h, max(dx, 0) : max(dx, 0) + w]


def _pos_mask(h: int, w: int, dy: int, dx: int, device=None) -> torch.Tensor:
    """Centre pixels whose (dy, dx) neighbour lies inside the reference's
    window: in-bounds AND not the last row/column."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (
        (ys + dy >= 0) & (ys + dy <= h - 2)
        & (xs + dx >= 0) & (xs + dx <= w - 2)
    )


def bilateral_filter(
    depth: torch.Tensor,
    kernel_size: int = 7,
    sigma_spatial: float = 4.5,
    sigma_depth: float = 0.04,
    reference_semantics: bool = False,
) -> torch.Tensor:
    """Edge-preserving bilateral filter on a metric depth image [H, W].

    Weight ``exp(-(dx^2+dy^2)/2 sigma_s^2 - dd^2/2 sigma_d^2)``; invalid
    pixels stay invalid.  ``reference_semantics`` lets invalid zeros
    participate inside the reference's positional window.
    """
    inv2_s = 0.5 / (sigma_spatial * sigma_spatial)
    inv2_d = 0.5 / (sigma_depth * sigma_depth)
    r = kernel_size // 2
    h, w = depth.shape
    valid = depth > 0.0

    wsum = torch.zeros_like(depth)
    vsum = torch.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = _shifted(depth, dy, dx)
            if reference_semantics:
                nb_ok = _pos_mask(h, w, dy, dx, device=depth.device)
            else:
                nb_ok = nb > 0.0
            diff = depth - nb
            weight = torch.exp(
                -((dy * dy + dx * dx) * inv2_s + diff * diff * inv2_d)
            )
            weight = torch.where(nb_ok, weight, 0.0)
            wsum = wsum + weight
            vsum = vsum + weight * nb
    out = vsum / torch.clamp(wsum, min=1e-12)
    return torch.where(valid, out, 0.0)


def truncate_depth(depth: torch.Tensor, max_dist: float) -> torch.Tensor:
    """Zero out depths beyond ``max_dist`` meters."""
    return torch.where(depth > max_dist, 0.0, depth)


def downsample_depth(
    depth: torch.Tensor,
    sigma_depth: float = 0.04,
    reference_semantics: bool = False,
) -> torch.Tensor:
    """2x depth downsample with discontinuity rejection.

    dst[y, x] = mean of the 5x5 neighbourhood of src[2y, 2x] restricted to
    valid samples within 3*sigma_depth of the centre
    (``reference_semantics``: the reference's positional window instead
    of the validity test).  Tap ``src[2y+dy, 2x+dx]`` is read as a shift
    by ``dy >> 1`` of the parity plane ``src[dy & 1::2]``, which keeps
    the JAX package's treatment of an odd last row/column.
    """
    h, w = depth.shape
    h2, w2 = h // 2, w // 2
    planes = [
        [depth[by : h2 * 2 : 2, bx : w2 * 2 : 2] for bx in (0, 1)]
        for by in (0, 1)
    ]
    center = planes[0][0]
    thresh = 3.0 * sigma_depth
    if reference_semantics:
        ys = torch.arange(h2, device=depth.device)[:, None] * 2
        xs = torch.arange(w2, device=depth.device)[None, :] * 2

    ssum = torch.zeros_like(center)
    scount = torch.zeros_like(center)
    for dy in range(-2, 3):
        ay, by = dy >> 1, dy & 1
        for dx in range(-2, 3):
            ax, bx = dx >> 1, dx & 1
            nb = _shifted(planes[by][bx], ay, ax)
            ok = torch.abs(nb - center) < thresh
            if reference_semantics:
                ok = ok & (
                    (ys + dy >= 0) & (ys + dy <= h - 2)
                    & (xs + dx >= 0) & (xs + dx <= w - 2)
                )
            else:
                ok = ok & (nb > 0.0)
            ssum = ssum + torch.where(ok, nb, 0.0)
            scount = scount + ok.to(depth.dtype)
    out = ssum / torch.clamp(scount, min=1.0)
    if reference_semantics:
        return torch.where(scount > 0.0, out, 0.0)
    return torch.where((center > 0.0) & (scount > 0.0), out, 0.0)


def build_depth_pyramid(
    depth: torch.Tensor, cfg: PreprocConfig
) -> List[torch.Tensor]:
    """Level-0 filtered depth -> list of ``cfg.pyramid_levels`` images."""
    pyr = [depth]
    for _ in range(cfg.pyramid_levels - 1):
        pyr.append(
            downsample_depth(
                pyr[-1],
                cfg.pyramid_sigma_depth,
                reference_semantics=cfg.reference_edge_semantics,
            )
        )
    return pyr


def preprocess_depth(
    depth_mm: torch.Tensor, cfg: PreprocConfig
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Full depth frontend: sensor units -> (integration depth, pyramid).

    The integration depth comes from the RAW depth; the ICP pyramid is
    bilateral-filtered then truncated.
    """
    raw_m = depth_to_meters(depth_mm, cfg.max_sensor_depth)
    filtered = bilateral_filter(
        raw_m,
        cfg.bilateral_kernel_size,
        cfg.bilateral_sigma_spatial,
        cfg.bilateral_sigma_depth,
        reference_semantics=cfg.reference_edge_semantics,
    )
    filtered = truncate_depth(filtered, cfg.depth_truncation)
    return raw_m, build_depth_pyramid(filtered, cfg)
