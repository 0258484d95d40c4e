# Frozen copy of topfusion_tpu_torch/ops/blockmap.py at commit 81038a6, the yardstick's plain reference.
"""Block-sparse voxel map (port of ``topfusion_tpu/ops/blockmap.py``).

Three dense arrays, as in the JAX package:

  * ``bucket_keys / bucket_slots [NUM_BUCKETS, WAYS]`` — a W-way bucketed
    hash table probed with one gather + compare (Teschner 3-prime XOR
    hash);
  * ``tsdf / weight [CAPACITY + 1, B, B, B]`` — the slot-indexed voxel
    pool, plus one sacrificial row at index ``capacity`` that padded
    entries route to; with ``use_color`` a ``[CAPACITY + 1, B, B, B, 3]``
    RGB pool in the same storage dtype (the TSDF codec: [0, 1] scaled by
    32767 for int16), else a ``[1, 1, 1, 1, 3]`` dummy;
  * deterministic allocation: sort -> unique -> probe -> prefix-sum rank
    -> scatter, so slots line up with the JAX package's slot for slot.

A sharded map (``parallel/block_sharded.py``) hashes into a global bucket
space of ``nb_local * num_shards`` buckets: the low hash bits name the
owning shard, the high bits the bucket in its local table
(:func:`_bucket_owner`).  The ``shard = (shard_id, num_shards)``
arguments below take Python ints; a shard's lookups report blocks owned
by other shards as not found, so remote space reads as free.

PyTorch has no ``mode="drop"`` scatter: out-of-range indices raise on
the CPU and assert on the card.  Every dropped write here goes to one
extra trailing element of a scratch buffer, which is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import BlockMapConfig

EMPTY_KEY = 2**31 - 1  # int32 max: unoccupied / invalid

# --------------------------------------------------------------- pool codec
# float32 plain; bfloat16 half-width float; int16 fixed point (sdf scaled
# by 32767, the original engine's Voxel_s encoding; weights stored as
# exact integers).  All semantic compute is float32.
POOL_I16_SCALE = 32767.0

_POOL_DTYPES = {
    "float32": torch.float32,
    "int16": torch.int16,
    "bfloat16": torch.bfloat16,
}


def pool_dtype(name: str) -> torch.dtype:
    return _POOL_DTYPES[name]


def decode_tsdf(a: torch.Tensor) -> torch.Tensor:
    """Storage -> semantic float32 TSDF in [-1, 1]."""
    if a.dtype == torch.int16:
        # float32(1/32767), as the JAX package's weak-typed constant.
        return a.to(torch.float32) * (1.0 / POOL_I16_SCALE)
    return a.to(torch.float32)


def encode_tsdf(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Semantic float32 TSDF -> storage (round half to even)."""
    if dtype == torch.int16:
        return torch.round(
            torch.clamp(x, -1.0, 1.0) * POOL_I16_SCALE
        ).to(torch.int16)
    return x.to(dtype)


def decode_weight(a: torch.Tensor) -> torch.Tensor:
    """Storage -> semantic float32 fusion weight (unscaled, all dtypes)."""
    return a.to(torch.float32)


def encode_weight(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int16:
        return torch.round(x).to(torch.int16)
    return x.to(dtype)


def tsdf_init_value(dtype: torch.dtype):
    """Encoded SDF_initialValue = 1.0 (free space)."""
    return int(POOL_I16_SCALE) if dtype == torch.int16 else 1.0


class BlockMap(NamedTuple):
    bucket_keys: torch.Tensor    # [NB, W] int32 packed keys, EMPTY_KEY = free
    bucket_slots: torch.Tensor   # [NB, W] int32 pool slot per key
    block_coords: torch.Tensor   # [C, 3] int32 unpacked coords per slot
    tsdf: torch.Tensor           # [C+1, B, B, B] pool dtype
    weight: torch.Tensor         # [C+1, B, B, B] pool dtype
    num_blocks: torch.Tensor     # () int32
    color: torch.Tensor          # [C+1, B, B, B, 3] or [1, 1, 1, 1, 3] dummy

    @property
    def capacity(self) -> int:
        return self.tsdf.shape[0] - 1

    @property
    def block_size(self) -> int:
        return self.tsdf.shape[1]


# ----------------------------------------------------------------- keys
def pack_key(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed block coords (..., 3) -> packed non-negative int32 key."""
    off = 1 << (bits - 1)
    c = coords + off
    return (c[..., 0] << (2 * bits)) | (c[..., 1] << bits) | c[..., 2]


def unpack_key(key: torch.Tensor, bits: int) -> torch.Tensor:
    off = 1 << (bits - 1)
    mask = (1 << bits) - 1
    x = (key >> (2 * bits)) & mask
    y = (key >> bits) & mask
    z = key & mask
    return torch.stack([x - off, y - off, z - off], dim=-1)


def in_coord_range(coords: torch.Tensor, bits: int) -> torch.Tensor:
    lim = 1 << (bits - 1)
    return torch.all((coords >= -lim) & (coords < lim), dim=-1)


def spatial_hash(coords: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Teschner 3-prime XOR hash; num_buckets must be a power of two.

    The JAX package multiplies in int32 and relies on wrap-around.  Here
    the products are taken in int64: the low bits of a product and of an
    XOR depend only on the low bits of the operands, so the bucket
    (masked by ``num_buckets - 1``) is the same for every coordinate.
    """
    c = coords.to(torch.int64)
    h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349669) ^ (c[..., 2] * 83492791)
    return (h & (num_buckets - 1)).to(torch.int32)


def _bucket_owner(coords: torch.Tensor, nb_local: int, shard):
    """(local bucket, ownership mask or None) of block coords (..., 3).

    Unsharded maps (``shard`` None) hash into their own table.  Sharded
    maps hash into the global bucket space of ``nb_local * num_shards``
    buckets; ``shard = (shard_id, num_shards)`` owns the global buckets
    whose residue mod ``num_shards`` is ``shard_id``, and keeps them at
    local bucket ``global // num_shards``.
    """
    if shard is None:
        return spatial_hash(coords, nb_local), None
    shard_id, num_shards = shard
    gb = spatial_hash(coords, nb_local * num_shards)
    return torch.div(gb, num_shards, rounding_mode="floor"), gb % num_shards == shard_id


# ----------------------------------------------------------------- ctor
def make_block_map(
    cfg: BlockMapConfig, ways: int = 4, dtype=None, use_color: bool = False,
    device=None,
) -> BlockMap:
    """Empty map: ``capacity`` buckets of ``ways`` ways, and a pool of
    ``capacity`` live rows plus the sacrificial row (a color pool of the
    same rows with ``use_color``)."""
    nb = cfg.capacity
    b = cfg.block_size
    if dtype is None:
        dtype = pool_dtype(cfg.pool_dtype)
    rows = (cfg.capacity + 1, b, b, b)
    color_shape = rows + (3,) if use_color else (1, 1, 1, 1, 3)
    return BlockMap(
        bucket_keys=torch.full((nb, ways), EMPTY_KEY, dtype=torch.int32, device=device),
        bucket_slots=torch.zeros((nb, ways), dtype=torch.int32, device=device),
        block_coords=torch.zeros((cfg.capacity, 3), dtype=torch.int32, device=device),
        tsdf=torch.full(rows, tsdf_init_value(dtype), dtype=dtype, device=device),
        weight=torch.zeros(rows, dtype=dtype, device=device),
        num_blocks=torch.zeros((), dtype=torch.int32, device=device),
        color=torch.zeros(color_shape, dtype=dtype, device=device),
    )


def reset_block_map(m: BlockMap) -> BlockMap:
    """ResetScene equivalent: every array back to its empty value."""
    return BlockMap(
        bucket_keys=torch.full_like(m.bucket_keys, EMPTY_KEY),
        bucket_slots=torch.zeros_like(m.bucket_slots),
        block_coords=torch.zeros_like(m.block_coords),
        tsdf=torch.full_like(m.tsdf, tsdf_init_value(m.tsdf.dtype)),
        weight=torch.zeros_like(m.weight),
        num_blocks=torch.zeros_like(m.num_blocks),
        color=torch.zeros_like(m.color),
    )


def select_block_map(cond: torch.Tensor, m: BlockMap) -> BlockMap:
    """``reset_block_map(m) if cond else m`` for a device bool ``cond``,
    without a host sync and without materializing the empty map."""
    empty = {
        "bucket_keys": EMPTY_KEY,
        "tsdf": tsdf_init_value(m.tsdf.dtype),
    }
    return BlockMap(*[
        torch.where(cond, empty.get(name, 0), a)
        for name, a in zip(BlockMap._fields, m)
    ])


def voxel_centers(
    block_coords: torch.Tensor, block_size: int, voxel_size: float
) -> torch.Tensor:
    """World position [V, B, B, B, 3] of every voxel centre of blocks
    ``block_coords`` [V, 3].  Voxel (x, y, z) of a block sits at pool
    offset x*B*B + y*B + z."""
    b = block_size
    ar = torch.arange(b, dtype=torch.float32, device=block_coords.device)
    local = torch.stack(
        [
            ar.view(1, b, 1, 1).expand(1, b, b, b),
            ar.view(1, 1, b, 1).expand(1, b, b, b),
            ar.view(1, 1, 1, b).expand(1, b, b, b),
        ],
        dim=-1,
    )                                                            # [1,B,B,B,3]
    base = block_coords.to(torch.float32)[:, None, None, None, :] * b
    return (base + local + 0.5) * voxel_size


# ----------------------------------------------------------------- lookup
def lookup(
    m: BlockMap, coords: torch.Tensor, bits: int, shard=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched block lookup: coords (..., 3) -> (slot (...,), found (...,)).
    With ``shard``, blocks that other shards own report not found."""
    key = pack_key(coords, bits)
    b, mine = _bucket_owner(coords, m.bucket_keys.shape[0], shard)
    b = b.long()
    ways_keys = m.bucket_keys[b]            # (..., W)
    ways_slots = m.bucket_slots[b]          # (..., W)
    match = ways_keys == key[..., None]
    found = torch.any(match, dim=-1) & in_coord_range(coords, bits)
    if mine is not None:
        found = found & mine
    slot = torch.sum(torch.where(match, ways_slots, 0), dim=-1, dtype=torch.int32)
    return torch.where(found, slot, -1), found


# ----------------------------------------------------------------- alloc
class AllocInfo(NamedTuple):
    """Extended allocation result (``allocate(..., return_touched=True)``).

    ``touched_*`` lists every unique candidate block present in the map
    after the call (pre-existing + newly inserted).  ``n_dropped_capacity``
    counts new unique candidates rejected by pool exhaustion;
    ``n_dropped_deferred`` those deferred by the per-frame bound or by
    W-way bucket overflow (both re-marked next frame).
    """

    n_inserted: torch.Tensor          # () int32
    n_dropped_capacity: torch.Tensor  # () int32
    n_dropped_deferred: torch.Tensor  # () int32
    touched_slots: torch.Tensor       # [t_max] int32 pool slots (pad = -1)
    touched_mask: torch.Tensor        # [t_max] bool


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), dim=0, dtype=torch.int32)


def allocate(
    m: BlockMap,
    cand_coords: torch.Tensor,
    cand_valid: torch.Tensor,
    cfg: BlockMapConfig,
    shard=None,
    return_touched: bool = False,
):
    """Deterministically insert new blocks for candidate coords [N, 3].

    sort -> unique -> probe -> prefix-sum rank -> scatter, bounded by
    ``cfg.max_new_blocks_per_frame`` and pool capacity.  Returns the new
    map (new hash tables; the pool tensors are shared with ``m``) and the
    number inserted, or ``(map, AllocInfo)`` with ``return_touched``.

    With ``shard = (shard_id, num_shards)`` only the candidates this
    shard owns are inserted: every shard runs the same allocation over
    the same candidates, and ownership routes each block to exactly one
    shard with no communication.
    """
    bits = cfg.coord_bits
    n_max = cfg.max_new_blocks_per_frame
    ways = m.bucket_keys.shape[1]
    nb = m.bucket_keys.shape[0]
    dev = cand_coords.device

    cand_valid = cand_valid & in_coord_range(cand_coords, bits)
    if shard is not None:
        cand_valid = cand_valid & _bucket_owner(cand_coords, nb, shard)[1]
    keys = torch.where(cand_valid, pack_key(cand_coords, bits), EMPTY_KEY)

    # Sort: duplicates adjacent, invalids at the end.
    keys_sorted = torch.sort(keys).values
    first = torch.ones_like(keys_sorted, dtype=torch.bool)
    first[1:] = keys_sorted[1:] != keys_sorted[:-1]
    uniq = first & (keys_sorted != EMPTY_KEY)

    # Membership probe against the existing table.
    coords_sorted = unpack_key(keys_sorted, bits)
    slot_sorted, exists = lookup(m, coords_sorted, bits, shard=shard)
    is_new = uniq & ~exists

    # Rank new keys; cap by per-frame bound and remaining capacity.
    rank = _cumsum_i32(is_new) - 1
    room = torch.clamp(m.capacity - m.num_blocks, max=n_max)
    keep = is_new & (rank < room)

    # Compact kept keys into [n_max] via scatter-by-rank (dropped -> the
    # extra last element).
    new_keys = torch.full((n_max + 1,), EMPTY_KEY, dtype=torch.int32, device=dev)
    new_keys[torch.where(keep, rank, n_max).long()] = torch.where(keep, keys_sorted, EMPTY_KEY)
    new_keys = new_keys[:n_max]
    new_valid = new_keys != EMPTY_KEY
    new_coords = unpack_key(new_keys, bits)

    # Way assignment: occupancy of each bucket + rank of this key among
    # earlier batch keys sharing the bucket (an [n_max, n_max] compare,
    # as in the JAX package).
    bucket = torch.where(new_valid, _bucket_owner(new_coords, nb, shard)[0], nb)
    ar = torch.arange(n_max, device=dev)
    prev_same = (bucket[None, :] == bucket[:, None]) & (ar[None, :] < ar[:, None])
    batch_rank = torch.sum(prev_same, dim=1, dtype=torch.int32)
    occ = torch.sum(m.bucket_keys != EMPTY_KEY, dim=1, dtype=torch.int32)
    way = torch.where(new_valid, occ[torch.clamp(bucket, 0, nb - 1).long()] + batch_rank, ways)
    fits = new_valid & (way < ways)

    # Re-rank after dropping bucket-overflow keys so slots stay contiguous.
    slot_rank = _cumsum_i32(fits) - 1
    slot = m.num_blocks + slot_rank
    n_inserted = torch.sum(fits, dtype=torch.int32)

    flat_idx = torch.where(fits, bucket * ways + way, nb * ways).long()
    bucket_keys = torch.cat([m.bucket_keys.reshape(-1), m.bucket_keys.new_zeros(1)])
    bucket_keys[flat_idx] = torch.where(fits, new_keys, EMPTY_KEY)
    bucket_slots = torch.cat([m.bucket_slots.reshape(-1), m.bucket_slots.new_zeros(1)])
    bucket_slots[flat_idx] = torch.where(fits, slot, 0)
    block_coords = torch.cat([m.block_coords, m.block_coords.new_zeros(1, 3)])
    block_coords[torch.where(fits, slot, m.capacity).long()] = new_coords

    new_map = m._replace(
        bucket_keys=bucket_keys[:-1].reshape(nb, ways),
        bucket_slots=bucket_slots[:-1].reshape(nb, ways),
        block_coords=block_coords[:-1],
        num_blocks=m.num_blocks + n_inserted,
    )
    if not return_touched:
        return new_map, n_inserted

    # Touched set: unique candidates present after the call (existing +
    # inserted), compacted into [t_max] slots.
    t_max = cfg.max_visible_blocks
    exist_t = uniq & exists
    rank_e = _cumsum_i32(exist_t) - 1
    n_e = torch.sum(exist_t, dtype=torch.int32)
    touched = torch.full((t_max + 1,), -1, dtype=torch.int32, device=dev)
    idx_e = torch.where(exist_t & (rank_e < t_max), rank_e, t_max).long()
    touched[idx_e] = torch.where(exist_t, slot_sorted, -1)
    rank_i = slot_rank + n_e
    idx_i = torch.where(fits & (rank_i < t_max), rank_i, t_max).long()
    touched[idx_i] = torch.where(fits, slot, -1)
    touched = touched[:t_max]
    n_want = torch.sum(is_new, dtype=torch.int32)
    # Capacity attribution: drops that would NOT have happened with more
    # free slots (room = min(per-frame bound, free)).
    n_cap = torch.clamp(torch.clamp(n_want, max=n_max) - room, min=0)
    return new_map, AllocInfo(
        n_inserted=n_inserted,
        n_dropped_capacity=n_cap,
        n_dropped_deferred=(n_want - n_inserted) - n_cap,
        touched_slots=touched,
        touched_mask=touched >= 0,
    )


# ----------------------------------------------------------------- voxel reads
def _split_voxel(m: BlockMap, voxel_coords: torch.Tensor, bits: int, shard=None):
    """Global integer voxel coords (..., 3) -> (pool row, local x, y, z,
    found): the row is 0 where the block is missing.  Floor division, so
    negative coordinates land in the block below, not the one toward 0."""
    bsz = m.block_size
    block = torch.div(voxel_coords, bsz, rounding_mode="floor")
    local = (voxel_coords - block * bsz).long()
    slot, found = lookup(m, block, bits, shard=shard)
    sl = torch.where(found, slot, 0).long()
    return sl, local[..., 0], local[..., 1], local[..., 2], found


def read_voxels_nearest(
    m: BlockMap, voxel_coords: torch.Tensor, bits: int, shard=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global integer voxel coords (..., 3) -> (tsdf, weight, block_found),
    semantic float32 whatever the pool dtype.  Unallocated space, and on a
    sharded map space that other shards own, reads as free (tsdf = 1,
    w = 0)."""
    sl, lx, ly, lz, found = _split_voxel(m, voxel_coords, bits, shard)
    t = decode_tsdf(m.tsdf[sl, lx, ly, lz])
    w = decode_weight(m.weight[sl, lx, ly, lz])
    return torch.where(found, t, 1.0), torch.where(found, w, 0.0), found


def read_color_nearest(
    m: BlockMap, voxel_coords: torch.Tensor, bits: int, shard=None
) -> torch.Tensor:
    """Global integer voxel coords (..., 3) -> RGB in [0, 1]; unallocated
    space, and a map built without ``use_color``, read black."""
    if m.color.shape[0] <= 1:
        return torch.zeros(
            voxel_coords.shape[:-1] + (3,), dtype=torch.float32,
            device=voxel_coords.device,
        )
    sl, lx, ly, lz, found = _split_voxel(m, voxel_coords, bits, shard)
    c = decode_tsdf(m.color[sl, lx, ly, lz])
    return torch.where(found[..., None], c, 0.0)


def sample_trilinear(
    m: BlockMap, pv: torch.Tensor, bits: int, shard=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear (tsdf, min-weight) at fractional global voxel coords,
    crossing block borders through a lookup per corner.  The eight terms
    are added in the JAX package's order (x outermost, z innermost)."""
    p = pv - 0.5
    base_f = torch.floor(p)
    base = base_f.to(torch.int32)
    frac = p - base_f
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    tsdf = torch.zeros(pv.shape[:-1], dtype=torch.float32, device=pv.device)
    wmin = torch.full_like(tsdf, float("inf"))
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = torch.stack(
                    [base[..., 0] + cx, base[..., 1] + cy, base[..., 2] + cz], dim=-1
                )
                t, w, _ = read_voxels_nearest(m, corner, bits, shard=shard)
                wgt = (
                    (fx if cx else 1.0 - fx)
                    * (fy if cy else 1.0 - fy)
                    * (fz if cz else 1.0 - fz)
                )
                tsdf = tsdf + wgt * t
                wmin = torch.minimum(wmin, w)
    return tsdf, wmin
