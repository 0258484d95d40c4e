"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference (``fusionbench/reference``)
produces from the same state and frames.  Each is 0 when the two agree
to the bit; the limits are in each configuration's file.

  pose_gap_mm     the largest gap of a compared pose's entries, the
                  rotation's read as millimetres at one metre; infinite
                  where the two disagree on a frame's tracking (``ok``)
                  or, in the SLAM system, on a loop closure;
  sdf_gap_mm      the mean gap of the TSDF over every voxel that either
                  map has fused (a block only one map holds counts as
                  free space, +mu, with weight 0, in the other), in mm;
  weight_gap      the mean gap of the fusion weight over the same voxels;
  model_gap_mm    the mean distance between the model points the next
                  frame tracks against (pyramid level 0), over pixels
                  that either side holds.
"""

from __future__ import annotations

import math

import torch

from .reference.ops.blockmap import decode_tsdf, decode_weight

def pose_gap_mm(Tp: torch.Tensor, Tr: torch.Tensor) -> float:
    d = (Tp.to(torch.float64) - Tr.to(torch.float64)).abs()[..., :3, :4]
    return float(d.max()) * 1000.0 if d.numel() else 0.0


def _keys(coords: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _gather(m, keys: torch.Tensor):
    """(tsdf, weight) [U, voxels] of the blocks ``keys`` in map ``m``;
    a block it does not hold reads as free space with weight 0."""
    n = int(m.num_blocks)
    k = _keys(m.block_coords[:n])
    order = torch.argsort(k)
    ks = k[order]
    pos = torch.searchsorted(ks, keys).clamp(max=max(n - 1, 0))
    found = (ks[pos] == keys) if n else torch.zeros_like(keys, dtype=torch.bool)
    slot = order[pos] if n else torch.zeros_like(keys)
    t = decode_tsdf(m.tsdf[slot]).reshape(len(keys), -1)
    w = decode_weight(m.weight[slot]).reshape(len(keys), -1)
    t = torch.where(found[:, None], t, 1.0)
    w = torch.where(found[:, None], w, 0.0)
    return t, w


def map_gaps(mp, mr, trunc_dist: float) -> tuple:
    """(sdf_gap_mm, weight_gap) of two block maps (any NamedTuples with
    ``block_coords``, ``tsdf``, ``weight``, ``num_blocks``, on one
    device)."""
    keys = torch.unique(torch.cat([_keys(mp.block_coords[: int(mp.num_blocks)]),
                                   _keys(mr.block_coords[: int(mr.num_blocks)])]))
    if not len(keys):
        return 0.0, 0.0
    sdf, wt = 0.0, 0.0
    n = 0
    for i in range(0, len(keys), 8192):
        kk = keys[i:i + 8192]
        tp, wp = _gather(mp, kk)
        tr, wr = _gather(mr, kk)
        live = (wp > 0) | (wr > 0)
        sdf += float(torch.sum(torch.where(live, (tp - tr).abs(), 0.0), dtype=torch.float64))
        wt += float(torch.sum(torch.where(live, (wp - wr).abs(), 0.0), dtype=torch.float64))
        n += int(live.sum())
    n = max(n, 1)
    return sdf / n * trunc_dist * 1000.0, wt / n


def model_gap_mm(pp: torch.Tensor, pr: torch.Tensor) -> float:
    """Mean distance (mm) of two [H, W, 3] point maps over the pixels
    either holds (a zero point is a hole)."""
    held = torch.any(pp != 0, dim=-1) | torch.any(pr != 0, dim=-1)
    d = torch.sqrt(torch.sum((pp.to(torch.float64) - pr.to(torch.float64)) ** 2, dim=-1))
    n = int(held.sum())
    return float(d[held].sum()) / n * 1000.0 if n else 0.0


def worst(a: dict, b: dict) -> dict:
    """The larger of each number of two comparisons."""
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in set(a) | set(b)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of a run's numbers; a
    number without a limit, or one that is not finite, fails."""
    out = {}
    ok = bool(numbers)
    for k in sorted(numbers):
        v, lim = numbers[k], limits.get(k)
        out[k] = {"value": v if math.isfinite(v) else str(v), "limit": lim}
        ok = ok and lim is not None and math.isfinite(v) and v <= lim
    return ok, out
