"""The map axis of the sharded pipeline: a process group of
``torch.distributed``, one process per shard.

It stands where the JAX package's ``Mesh`` and axis name stood
(``topfusion_tpu/parallel/block_sharded.py``).  The JAX package runs one
program over a mesh under ``shard_map``; here every shard is a process
that runs the per-shard body itself and meets the others in real
collectives:

    lax.axis_index              -> MapAxis.rank
    lax.psum                    -> MapAxis.psum    (all_reduce SUM)
    lax.pmin                    -> MapAxis.pmin    (all_reduce MIN)
    lax.all_gather(tiled=True)  -> MapAxis.all_gather_tiled
                                   (all_gather into a list, then cat)

and two that a single SPMD program does not need: ``MapAxis.broadcast``
(member 0's tensor to every member: where the members' host code
branches on a fetched value, they branch on the same one) and
``MapAxis.all_gather_object`` (picklable host values, e.g. a host
cache's store entries).

Every member must issue the same collectives in the same order, so no
caller may branch in Python on a value that differs between shards.

Every backend gets the shards' tensors as they are: NCCL on the card,
gloo on the CPU and on the card (gloo's ``all_reduce`` SUM / MIN and
``all_gather`` take CUDA tensors; a world of gloo processes sharing one
card runs so).

``MapAxis.calls`` and ``MapAxis.bytes`` count the collectives issued and
the bytes each member handed to them (its own payload: for a gather,
one member's part), for per-frame traffic figures.
"""

from __future__ import annotations

import pickle

import torch
import torch.distributed as dist


class MapAxis:
    """The shards of one sharded map: a process group (``None``: the
    default group), this process's rank in it, the group's size, and the
    device this shard's tensors live on (``"cuda"`` is the current card)."""

    def __init__(self, group=None, device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError(
                "MapAxis: torch.distributed is not initialized; start one process "
                "per shard (parallel.launch.spawn_world) and init_process_group first"
            )
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.calls = 0
        self.bytes = 0

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        self._count(t)
        buf = t.clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the shards (a new tensor; ``t`` is kept)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the shards (a new tensor)."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def psum_gram(self, G: torch.Tensor, count: torch.Tensor):
        """ICP's 7x7 Gram matrix and its int32 correspondence count summed
        over the shards in one collective.  The count rides as a float32,
        which is exact below 2^24 correspondences (an image of 16.7 M
        pixels)."""
        packed = torch.cat([G.reshape(-1), count.to(torch.float32).reshape(1)])
        total = self.psum(packed)
        return total[:49].reshape(7, 7), total[49].to(torch.int32)

    def all_gather_tiled(self, t: torch.Tensor) -> torch.Tensor:
        """Every member's ``t`` concatenated along dim 0 in rank order
        (booleans travel as uint8)."""
        self._count(t)
        src = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Member 0's ``t`` on every member (a new tensor)."""
        self._count(t)
        buf = t.contiguous().clone()
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(buf, src=src, group=self.group)
        return buf

    def all_gather_object(self, obj) -> list:
        """Every member's picklable ``obj`` in rank order.  Counts one
        call and this member's pickled size."""
        self.calls += 1
        self.bytes += len(pickle.dumps(obj))
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def __repr__(self) -> str:
        return (f"MapAxis(rank={self.rank}, size={self.size}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")


def make_mesh(device="cuda", group=None) -> MapAxis:
    """The map axis over an initialized process group (the default group
    unless ``group`` is given), on ``device``: the card unless the
    caller names another, a ``RuntimeError`` where there is none."""
    from ..utils.device_info import entry_device

    return MapAxis(group, entry_device(device))
