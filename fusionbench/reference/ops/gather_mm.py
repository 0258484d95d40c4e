# Frozen copy of topfusion_tpu_torch/ops/gather_mm.py at commit 81038a6, the yardstick's plain reference.
"""Banded projective gather (port of ``topfusion_tpu/ops/gather_mm.py``).

The JAX package computes this gather as a one-hot matrix product over
overlapping row bands, because the TPU has no fast hardware gather and
its MXU makes the product cheap.  The GPU gathers natively, and the
one-hot operands at VGA would take hundreds of MB per ICP iteration, so
the port keeps only the band geometry: which queries the band admits
(``in_band``) is computed with the JAX package's arithmetic, and the
admitted values are read with one row gather of the flattened map.

Contract: the map is finite.  The one-hot sum of the JAX package turns a
selected -0.0 into +0.0 whenever another product in the sum is +0.0, and
a NaN or inf anywhere in a band reaches every query of that tile
(0 * NaN = NaN); the gather reads only the selected element.  So on a
finite map the two agree bitwise with -0.0 and +0.0 counted equal.  The
model maps of both packages are finite, with exact zeros at invalid
pixels.
"""

from __future__ import annotations

from typing import Tuple

import torch


def banded_projective_gather(
    model: torch.Tensor,
    u_idx: torch.Tensor,
    v_idx: torch.Tensor,
    v_margin: int = 24,
    rows_per_tile: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather ``model[v_idx[i, j], u_idx[i, j]]`` for query grids
    organised by image row.

    Args:
      model: [H, W, C] float map, finite (see the module docstring).
      u_idx, v_idx: [h, w] integer pixel indices into ``model`` (any
        value: out-of-range or out-of-band queries return zeros and
        ``in_band`` False).  Queries at grid row i are expected near model
        row ``i * H / h``, within ``+-v_margin``.
      v_margin: half-height of the tolerated vertical displacement, pixels.
      rows_per_tile: query rows per band (default ``32 // stride``,
        lowered until it divides h).

    Returns:
      (gathered [h, w, C], in_band [h, w] bool).

    No data-dependent shape, host sync or in-place write: the function
    runs under ``torch.func.vmap``.
    """
    H, W, C = model.shape
    h, w = u_idx.shape
    stride = H // h  # the query grid may subsample the map's rows

    # Band geometry, as the JAX package: tiles of tr query rows, each
    # reading a band of b model rows centred on the tile.
    tr = max(1, 32 // stride) if rows_per_tile is None else rows_per_tile
    while h % tr != 0:
        tr -= 1
    span = tr * stride
    b = min(((span + 2 * v_margin + 7) // 8) * 8, H)

    tile = torch.arange(h, device=u_idx.device) // tr
    start = torch.clamp(tile * span + span // 2 - b // 2, 0, max(H - b, 0))[:, None]

    # int64, so that no index wraps around (int32 extremes come from
    # casts of off-image projections).
    u = u_idx.long()
    v = v_idx.long()
    v_rel = v - start
    u_ok = (u >= 0) & (u < W)
    v_ok = (v_rel >= 0) & (v_rel < b) & (v >= 0) & (v < H)
    ok = u_ok & v_ok

    flat = torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)
    out = model.reshape(H * W, C).index_select(0, flat.reshape(-1)).reshape(h, w, C)
    return torch.where(ok[..., None], out, 0.0), ok
