"""Host block cache: the out-of-core block pool's host side (port of
``HostBlockCache``, ``ShardedHostCache`` and ``host_visible_mask`` of
``topfusion_tpu/models/host_cache.py``).

A plain coord-keyed store plus a least-recently-seen policy over device
slots; the heavy lifting is the three batched device operations of
``ops/swap.py``.  The policy runs BETWEEN steps and is host code by
design: reading the live-block count, the visible list and the evicted
payload are host syncs, none of them inside a step.

  * after each step: update per-slot last-seen from the aged visible
    list, and while the free slots are fewer than the headroom, evict the
    coldest slots to the host store (one extract and one compaction per
    batch);
  * before each step: restore host-cached blocks that fall in the view
    frustum of the last known pose (restore lags one step, which
    frame-to-model tracking tolerates as it tolerates a one-frame-old
    model map), with one insert.

With a ``HostBlockCache`` attached, the scene a map can hold is bounded
by host memory, not by the pool's capacity.

``ShardedHostCache`` is the same policy for one shard of a
``parallel.block_sharded.ShardedBlockPipeline``: each shard's process
keeps its own store and decides for its own blocks.  Ownership is static
by hash, so a block evicted from a shard restores into the same shard,
and since evict and restore hold no collective, shards may swap
different amounts at different steps.

Payloads stay in the POOL dtype as CPU tensors (numpy has no bfloat16),
so evict -> restore is bit-exact for float32, int16 and bfloat16 pools.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import BlockMapConfig, CameraConfig, TSDFConfig
from ..ops.blockmap import BlockMap
from ..ops.swap import ExtractedBlocks, evict_blocks, extract_blocks, insert_blocks
from ..utils.device_info import entry_device

# What numpy makes of ``array <op> python_float`` for a stored payload of
# each pool dtype (the JAX package keeps numpy arrays, bfloat16 from
# ml_dtypes): ``remap_store`` reproduces its arithmetic, dtype included.
_NUMPY_FLOAT_OF = {
    torch.int16: torch.float64,
    torch.bfloat16: torch.float32,
    torch.float32: torch.float32,
    torch.float64: torch.float64,
}


def _stack(payloads) -> torch.Tensor:
    """``np.stack`` of per-block payloads, which promotes mixed dtypes
    (``remap_store`` leaves merged entries in a wider dtype), followed by
    the float64 -> float32 narrowing of the upload."""
    dtype = payloads[0].dtype
    for p in payloads[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    out = torch.stack([p.to(dtype) for p in payloads])
    return out.to(torch.float32) if dtype == torch.float64 else out


class HostBlockCache:
    """Coord-keyed host store + least-recently-seen eviction over the
    slots of a map on ``device`` (the card by default, a ``RuntimeError``
    where there is none)."""

    def __init__(
        self,
        bm_cfg: BlockMapConfig,
        tsdf_cfg: TSDFConfig,
        cam: CameraConfig,
        evict_batch: int = 1024,
        restore_batch: Optional[int] = None,
        headroom: Optional[int] = None,
        high_watermark: Optional[float] = None,
        device="cuda",
    ):
        self.bm_cfg = bm_cfg
        self.tsdf_cfg = tsdf_cfg
        self.cam = cam
        self.device = entry_device(device)
        self.evict_batch = evict_batch
        self.restore_batch = min(
            restore_batch or bm_cfg.max_new_blocks_per_frame,
            bm_cfg.max_new_blocks_per_frame,
        )
        # Headroom policy: keep FREE slots >= headroom at every step so a
        # burst frame (fresh allocation + a restore batch) never hits the
        # capacity wall between eviction opportunities.
        if headroom is None:
            if high_watermark is not None:
                headroom = int((1.0 - high_watermark) * bm_cfg.capacity)
            else:
                headroom = min(
                    bm_cfg.capacity // 2, evict_batch + self.restore_batch
                )
        self.headroom = headroom
        # coord tuple -> (tsdf [B,B,B], weight [B,B,B], color or None),
        # CPU tensors.
        self.store: Dict[Tuple[int, int, int], tuple] = {}
        self.last_seen = np.zeros(bm_cfg.capacity, np.int64)
        self._frame = 0

    @property
    def n_host_blocks(self) -> int:
        return len(self.store)

    # ------------------------------------------------------------- after
    def _note_visible(self, vis_slots) -> None:
        """Count a step and mark its visible slots (a tensor or an array,
        -1 = empty) as seen now."""
        self._frame += 1
        if isinstance(vis_slots, torch.Tensor):
            vis_slots = vis_slots.cpu().numpy()
        vs = np.asarray(vis_slots)
        self.last_seen[vs[vs >= 0]] = self._frame

    def _cold_slots(self, n_live: int) -> Optional[np.ndarray]:
        """The coldest live slots to evict while the free slots are fewer
        than the headroom, padded with -1 to ``evict_batch``; None when
        nothing needs evicting."""
        free = self.bm_cfg.capacity - n_live
        n_target = min(self.evict_batch, self.headroom - free, n_live)
        if n_target <= 0:
            return None
        order = np.argsort(self.last_seen[:n_live], kind="stable")
        slots = np.full((self.evict_batch,), -1, np.int32)
        slots[:n_target] = order[:n_target]
        return slots

    def _keep_evicted(self, ex: ExtractedBlocks, remap: torch.Tensor) -> np.ndarray:
        """Fetch an evicted payload into the host store and carry the
        recency over to the compacted slots; returns the remap as numpy."""
        coords = ex.coords.cpu().numpy()
        tsdf = ex.tsdf.cpu()
        weight = ex.weight.cpu()
        has_color = ex.color.shape[1] == tsdf.shape[1]
        color = ex.color.cpu() if has_color else None
        for i in np.nonzero(ex.valid.cpu().numpy())[0]:
            self.store[tuple(int(c) for c in coords[i])] = (
                tsdf[i], weight[i], color[i] if has_color else None,
            )
        remap_np = remap.cpu().numpy()
        new_seen = np.zeros_like(self.last_seen)
        kept = remap_np >= 0
        new_seen[remap_np[kept]] = self.last_seen[kept]
        self.last_seen = new_seen
        return remap_np

    def after_step(
        self, m: BlockMap, vis_slots
    ) -> Tuple[BlockMap, Optional[torch.Tensor]]:
        """Update recency from this step's visible list (a tensor or an
        array, -1 = empty); evict while the free slots are fewer than the
        headroom.  Returns (map, remap or None): when an eviction
        compacted the pool, ``remap`` is the old->new slot map
        ([capacity] int32 on the device, -1 = evicted) that the caller
        must apply to any slot-indexed side state (the aged visible
        list)."""
        self._note_visible(vis_slots)
        total_remap = None
        # Evict in batches until the free headroom is restored.
        while (slots := self._cold_slots(int(m.num_blocks))) is not None:
            slots_dev = torch.from_numpy(slots).to(self.device)
            ex = extract_blocks(m, slots_dev)
            m, remap = evict_blocks(m, slots_dev, self.bm_cfg)
            remap_np = self._keep_evicted(ex, remap)
            if total_remap is None:
                total_remap = remap_np
            else:
                total_remap = np.where(
                    total_remap >= 0,
                    remap_np[np.clip(total_remap, 0, len(remap_np) - 1)],
                    -1,
                )
        if total_remap is None:
            return m, None
        return m, torch.from_numpy(total_remap).to(self.device)

    # ------------------------------------------------------------ before
    def _restore_batch(self, T_wc):
        """(blocks, their coords [n, 3]) of up to ``restore_batch`` stored
        blocks visible from ``T_wc`` (a 4x4 tensor or array), padded to
        ``restore_batch`` on the device; None when there are none."""
        if not self.store:
            return None
        if isinstance(T_wc, torch.Tensor):
            T_wc = T_wc.cpu().numpy()
        coords = np.asarray(list(self.store.keys()), np.int32)
        vis = host_visible_mask(
            coords, np.asarray(T_wc), self.bm_cfg, self.tsdf_cfg, self.cam
        )
        idx = np.nonzero(vis)[0][: self.restore_batch]
        if len(idx) == 0:
            return None
        k = self.restore_batch
        sel = coords[idx]
        entries = [self.store[tuple(c)] for c in sel]
        tsdf = _stack([e[0] for e in entries])
        weight = _stack([e[1] for e in entries])
        if entries[0][2] is not None:
            color = _stack([e[2] for e in entries])
        else:
            color = torch.zeros((len(idx), 1, 1, 1, 3), dtype=tsdf.dtype)

        def pad(a: torch.Tensor) -> torch.Tensor:
            out = torch.zeros((k,) + a.shape[1:], dtype=a.dtype)
            out[: len(a)] = a
            return out.to(self.device)

        blocks = ExtractedBlocks(
            coords=pad(torch.from_numpy(sel)),
            tsdf=pad(tsdf),
            weight=pad(weight),
            color=pad(color),
            valid=(torch.arange(k) < len(idx)).to(self.device),
        )
        return blocks, sel

    def _drop_restored(self, sel: np.ndarray, ok: torch.Tensor) -> None:
        """Drop the restored entries (``ok``) of a batch from the store."""
        ok = ok.cpu().numpy()
        for i in range(len(sel)):
            if ok[i]:
                del self.store[tuple(sel[i])]

    def before_step(self, m: BlockMap, T_wc) -> BlockMap:
        """Restore host-cached blocks visible from ``T_wc`` (a 4x4 tensor
        or array: the last known pose, a one-step prediction lag), at
        most ``restore_batch`` of them."""
        batch = self._restore_batch(T_wc)
        if batch is None:
            return m
        blocks, sel = batch
        m, ok = insert_blocks(m, blocks, self.bm_cfg, self.tsdf_cfg.max_weight)
        self._drop_restored(sel, ok)
        return m

    # ------------------------------------------------------------ remap
    def remap_store(self, corr: np.ndarray) -> None:
        """Carry the host store through a map correction: rigidly
        transform each spilled block's centre by ``corr`` and re-key it
        to the nearest block coordinate; colliding keys MERGE by fusion
        weight.

        The voxel content is not resampled: exact for corrections that
        are near block-lattice translations, off by at most the
        correction's rotation times the block radius otherwise; the
        restore path's weighted merge then blends it with re-observed
        data.

        The merge works on the STORED values, as the JAX package does.
        For an int16 pool those are encoded (the tsdf scaled by 32767),
        so a merged entry holds ``t0 * w0`` wrapped around in int16 and
        then divided: a wrong value, in float64.  That is the JAX
        package's behaviour and is reproduced here, dtype included.
        """
        block_metric = self.bm_cfg.block_size * self.tsdf_cfg.voxel_size
        if not self.store:
            return
        corr = np.asarray(corr, np.float64)
        keys = np.asarray(list(self.store.keys()), np.float64)
        centers = (keys + 0.5) * block_metric
        moved = centers @ corr[:3, :3].T + corr[:3, 3]
        new_keys = np.floor(moved / block_metric).astype(np.int64)
        new_store: Dict[Tuple[int, int, int], tuple] = {}
        for (t, w, c), nk in zip(list(self.store.values()), new_keys):
            key = (int(nk[0]), int(nk[1]), int(nk[2]))
            if key in new_store:
                t0, w0, c0 = new_store[key]
                w01 = w0 + w
                w01 = w01.to(_NUMPY_FLOAT_OF[w01.dtype])
                wsum = torch.clamp(w01, min=1e-6)
                t = (t0 * w0 + t * w) / wsum
                if c0 is not None and c is not None:
                    c = (c0 * w0[..., None] + c * w[..., None]) / wsum[..., None]
                w = torch.clamp(w01, max=self.tsdf_cfg.max_weight)
            new_store[key] = (t, w, c)
        self.store = new_store


class ShardedHostCache(HostBlockCache):
    """The host cache of this process's shard of a sharded pipeline
    ``pipe``: the ``HostBlockCache`` policy over the shard's local slots,
    through ``pipe.swap_evict`` / ``pipe.swap_insert``, on ``pipe``'s
    device.  ``n_host_blocks`` counts this shard's store."""

    def __init__(
        self,
        pipe,  # parallel.block_sharded.ShardedBlockPipeline
        evict_batch: int = 1024,
        restore_batch: Optional[int] = None,
        headroom: Optional[int] = None,
    ):
        lc = pipe.local_cfg
        super().__init__(
            lc.blockmap, lc.tsdf, lc.camera, evict_batch=evict_batch,
            restore_batch=restore_batch, headroom=headroom, device=pipe.device,
        )
        self.pipe = pipe

    def after_step(self, state):
        """Update this shard's recency from its aged visible list and evict
        its coldest slots while its free slots are fewer than the
        headroom.  Returns the (possibly compacted) state, its visible
        list remapped."""
        self._note_visible(state.vis_slots)
        while (slots := self._cold_slots(int(state.num_blocks))) is not None:
            state, ex, remap = self.pipe.swap_evict(
                state, torch.from_numpy(slots).to(self.device))
            self._keep_evicted(ex, remap)
        return state

    def before_step(self, state, T_wc):
        """Restore this shard's stored blocks visible from ``T_wc``."""
        batch = self._restore_batch(T_wc)
        if batch is None:
            return state
        blocks, sel = batch
        state, ok = self.pipe.swap_insert(state, blocks)
        self._drop_restored(sel, ok)
        return state

    def remap_store(self, corr: np.ndarray) -> None:
        """Not ported: a re-keyed block may change its owning shard, so
        carrying the stores through a map correction needs an exchange
        between the shards' processes.  Its one caller is
        ``ShardedSlamSystem``, which is not ported yet."""
        raise NotImplementedError(
            "ShardedHostCache.remap_store moves blocks between the shards' "
            "processes; it comes with ShardedSlamSystem, its only caller, which "
            "is not ported yet"
        )


def host_visible_mask(
    coords: np.ndarray,
    T_wc: np.ndarray,
    bm_cfg: BlockMapConfig,
    tsdf_cfg: TSDFConfig,
    cam: CameraConfig,
) -> np.ndarray:
    """Conservative frustum test of block centres in numpy float64: the
    host's twin of ``ops/tsdf_block._block_frustum_mask``."""
    cfg = tsdf_cfg
    block_metric = bm_cfg.block_size * cfg.voxel_size
    radius = 0.5 * np.sqrt(3.0) * block_metric
    centers = (coords.astype(np.float64) + 0.5) * block_metric
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    pc = (centers - t) @ R  # R^T (p - t)
    z = pc[:, 2]
    zs = np.maximum(z, cfg.view_frustum_min * 0.5)
    u = pc[:, 0] / zs * cam.fx + cam.cx
    v = pc[:, 1] / zs * cam.fy + cam.cy
    ru = radius / zs * abs(cam.fx)
    rv = radius / zs * abs(cam.fy)
    return (
        (z > cfg.view_frustum_min - radius)
        & (z < cfg.view_frustum_max + radius)
        & (u >= -ru) & (u <= cam.width - 1 + ru)
        & (v >= -rv) & (v <= cam.height - 1 + rv)
    )
