"""Out-of-core voxel block pool: the device-side evict / restore
primitives (port of ``topfusion_tpu/ops/swap.py``).

The policy lives on the host (``models/host_cache.py``); the device side
is three batched operations on the block map, none of which reads a
value back to the host:

  * :func:`extract_blocks` — one row-gather of an explicit slot list (the
    host's cold set), to be fetched by the host;
  * :func:`evict_blocks` — remove those slots and COMPACT the pool (rank
    and scatter, then a sort-based rebuild of the whole bucket table), so
    the bump allocator keeps working and freed rows are reusable: no free
    list, no holes;
  * :func:`insert_blocks` — re-insert restored blocks (allocate, look up,
    merge by fusion weight), correct even when the area was re-observed
    and re-allocated while swapped out.

On a sharded map each shard evicts and restores its own blocks:
``shard = (shard_id, num_shards)`` keeps the bucket table in the global
bucket space (``ops/blockmap._bucket_owner``).

Where the JAX package scatters with ``mode="drop"`` to an out-of-range
index, the scratch buffer here has one extra trailing element that takes
those writes and is sliced off (see ``ops/blockmap.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import BlockMapConfig
from .blockmap import (
    EMPTY_KEY,
    BlockMap,
    _cumsum_i32,
    allocate,
    decode_tsdf,
    decode_weight,
    encode_tsdf,
    encode_weight,
    _bucket_owner,
    lookup,
    pack_key,
    tsdf_init_value,
)


class ExtractedBlocks(NamedTuple):
    """Host-transfer package for a batch of evicted blocks."""

    coords: torch.Tensor   # [K, 3] int32
    tsdf: torch.Tensor     # [K, B, B, B] pool dtype
    weight: torch.Tensor   # [K, B, B, B] pool dtype
    color: torch.Tensor    # [K, B, B, B, 3] (or [K, 1, 1, 1, 3] dummy)
    valid: torch.Tensor    # [K] bool


def _has_color(m: BlockMap) -> bool:
    return m.color.shape[0] == m.capacity + 1


def extract_blocks(m: BlockMap, slots: torch.Tensor) -> ExtractedBlocks:
    """Gather coords and voxel data for an explicit slot list [K]
    (pad = -1): one row-gather per pool tensor.  Entries that are not
    live slots gather the sacrificial row and are marked invalid."""
    cap = m.capacity
    valid = (slots >= 0) & (slots < m.num_blocks)
    safe = torch.where(valid, slots, cap).long()
    if _has_color(m):
        color = m.color[safe]
    else:
        color = torch.zeros(
            (slots.shape[0], 1, 1, 1, 3), dtype=m.tsdf.dtype, device=slots.device
        )
    return ExtractedBlocks(
        coords=m.block_coords[torch.where(valid, slots, 0).long()],
        tsdf=m.tsdf[safe],
        weight=m.weight[safe],
        color=color,
        valid=valid,
    )


def _scatter_drop(size: int, fill, dtype, idx: torch.Tensor, values) -> torch.Tensor:
    """``full(size, fill).at[idx].set(values, mode="drop")`` for indices in
    [0, size]: index ``size`` is the dropped one."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=idx.device)
    out[idx.long()] = values
    return out[:size]


def evict_blocks(
    m: BlockMap, slots: torch.Tensor, cfg: BlockMapConfig, shard=None
) -> Tuple[BlockMap, torch.Tensor]:
    """Remove the given slots [K] (pad = -1) and compact the pool.

    Kept blocks are compacted to the front in slot order (so the
    operation is deterministic) and the bucket table is rebuilt from the
    compacted coords: sort by bucket, rank within the bucket.  Every key
    that fitted before fits after (the kept keys are a subset per
    bucket).  Returns (new map, old->new slot remap [capacity] int32 with
    -1 for evicted); the remap lets callers fix slot-indexed side state
    such as the aged visible list.  ``m`` is not written.  ``shard``
    rebuilds the table in the sharded map's global bucket space (every
    block of a shard's map is its own, so only the bucket changes).
    """
    cap = m.capacity
    nb, ways = m.bucket_keys.shape
    dev = slots.device
    row = torch.arange(cap, dtype=torch.int32, device=dev)

    ev_valid = (slots >= 0) & (slots < m.num_blocks)
    # (A tensor of values: writing a Python scalar through an index would
    # copy it from the host.)
    evict_mask = _scatter_drop(
        cap, False, torch.bool, torch.where(ev_valid, slots, cap), ev_valid
    )
    live = row < m.num_blocks
    keep = live & ~evict_mask

    # Compaction permutation: new row i <- old slot old_of_new[i].
    rank = _cumsum_i32(keep) - 1
    n_new = torch.sum(keep, dtype=torch.int32)
    old_of_new = _scatter_drop(cap, cap, torch.int32, torch.where(keep, rank, cap), row).long()
    new_of_old = torch.where(keep, rank, -1)

    live_new = row < n_new
    rows = live_new[:, None, None, None]
    pool_t = torch.where(rows, m.tsdf[old_of_new], tsdf_init_value(m.tsdf.dtype))
    pool_w = torch.where(rows, m.weight[old_of_new], 0)
    coords_new = torch.where(
        live_new[:, None], m.block_coords[torch.clamp(old_of_new, max=cap - 1)], 0
    )
    if _has_color(m):
        pool_c = torch.where(rows[..., None], m.color[old_of_new], 0)
        color = torch.cat([pool_c, m.color[-1:]], dim=0)
    else:
        color = m.color

    # Bucket rebuild: sort compacted keys by bucket, rank within bucket.
    keys = torch.where(live_new, pack_key(coords_new, cfg.coord_bits), EMPTY_KEY)
    bucket = torch.where(live_new, _bucket_owner(coords_new, nb, shard)[0], nb)
    b_sorted, order = torch.sort(bucket, stable=True)
    first = torch.ones_like(b_sorted, dtype=torch.bool)
    first[1:] = b_sorted[1:] != b_sorted[:-1]
    seg_start = torch.cummax(torch.where(first, row, 0), dim=0).values
    way = row - seg_start
    fits = (b_sorted < nb) & (way < ways)  # subset property: always fits
    flat = torch.where(fits, b_sorted * ways + way, nb * ways)
    bucket_keys = _scatter_drop(
        nb * ways, EMPTY_KEY, torch.int32, flat, torch.where(fits, keys[order], EMPTY_KEY)
    )
    bucket_slots = _scatter_drop(
        nb * ways, 0, torch.int32, flat, torch.where(fits, order.to(torch.int32), 0)
    )

    new_map = BlockMap(
        bucket_keys=bucket_keys.reshape(nb, ways),
        bucket_slots=bucket_slots.reshape(nb, ways),
        block_coords=coords_new,
        tsdf=torch.cat([pool_t, m.tsdf[-1:]], dim=0),
        weight=torch.cat([pool_w, m.weight[-1:]], dim=0),
        num_blocks=n_new,
        color=color,
    )
    return new_map, new_of_old


def insert_blocks(
    m: BlockMap,
    blocks: ExtractedBlocks,
    cfg: BlockMapConfig,
    max_weight: float,
    shard=None,
) -> Tuple[BlockMap, torch.Tensor]:
    """Restore host-cached blocks into the map.

    Allocates any missing blocks (bounded by ``max_new_blocks_per_frame``:
    restore batches must respect it), then MERGES host data into device
    data with the running weighted average, so that neither copy is
    discarded if the region was re-observed while swapped out.  Returns
    (map, restored mask [K]); callers drop exactly the restored entries
    from the host store.  Entries that are not restored rewrite the
    sacrificial row with its own content, as in the JAX package.  ``m``
    is not written.  ``shard`` restores only the blocks this shard owns.
    """
    cap = m.capacity
    m, _ = allocate(m, blocks.coords, blocks.valid, cfg, shard=shard)
    slots, found = lookup(m, blocks.coords, cfg.coord_bits, shard=shard)
    ok = blocks.valid & found
    row = torch.where(ok, slots, cap).long()

    t_d = decode_tsdf(m.tsdf[row])
    w_d = decode_weight(m.weight[row])
    t_h = decode_tsdf(blocks.tsdf)
    w_h = decode_weight(blocks.weight)
    w_sum = w_d + w_h
    t_new = (t_d * w_d + t_h * w_h) / torch.clamp(w_sum, min=1.0)
    t_new = torch.where(w_sum > 0, t_new, 1.0)
    w_new = torch.clamp(w_sum, max=max_weight)
    okk = ok[:, None, None, None]
    new_tsdf = m.tsdf.clone()
    new_tsdf[row] = encode_tsdf(torch.where(okk, t_new, t_d), m.tsdf.dtype)
    new_weight = m.weight.clone()
    new_weight[row] = encode_weight(torch.where(okk, w_new, w_d), m.weight.dtype)
    color = m.color
    if _has_color(m) and blocks.color.shape[1] == m.color.shape[1]:
        c_d = decode_tsdf(m.color[row])
        c_h = decode_tsdf(blocks.color)
        wde = w_d[..., None]
        whe = w_h[..., None]
        c_new = (c_d * wde + c_h * whe) / torch.clamp(wde + whe, min=1.0)
        color = m.color.clone()
        color[row] = encode_tsdf(torch.where(okk[..., None], c_new, c_d), m.color.dtype)
    return m._replace(tsdf=new_tsdf, weight=new_weight, color=color), ok
