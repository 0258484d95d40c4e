"""Carry configs and state between the JAX package and the port, without
importing jax.

The system has no weights: what must carry across is the config tree,
the fusion state (hash table and voxel pool or dense volume, color, pose,
model maps, visible list, counters), the pose graph, and a SLAM system's
buffers and host bookkeeping, so that a state reached by one package can
be stepped, rendered, optimized and exported by the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import PipelineConfig
from .models.block_pipeline import BlockState
from .models.pipeline import DenseState
from .models.posegraph import PoseGraph
from .utils.device_info import entry_device

_TUPLE_FIELDS = ("model_points", "model_normals")


def _build(cls, values: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    if set(values) != names:
        raise ValueError(
            f"{cls.__name__}: fields differ from the port's "
            f"(missing {sorted(names - set(values))}, "
            f"unknown {sorted(set(values) - names)})"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = values[f.name]
        if dataclasses.is_dataclass(f.default):
            v = _build(type(f.default), v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_reference(obj) -> PipelineConfig:
    """The port's ``PipelineConfig`` from any dataclass tree with the same
    fields (e.g. a ``topfusion_tpu.config.PipelineConfig``)."""
    return _build(PipelineConfig, dataclasses.asdict(obj))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _state_from_numpy(cls, arrays: Mapping[str, Any], device):
    device = entry_device(device)
    fields = {}
    for name in cls._fields:
        v = arrays[name]
        if name in _TUPLE_FIELDS:
            fields[name] = tuple(_to_tensor(x, device) for x in v)
        else:
            fields[name] = _to_tensor(v, device)
    return cls(**fields)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16; widening to float32 is exact.
        t = t.to(torch.float32)
    return t.numpy()


def _state_to_numpy(state) -> Dict[str, Any]:
    out = {}
    for name, v in state._asdict().items():
        if name in _TUPLE_FIELDS:
            out[name] = tuple(_to_numpy(x) for x in v)
        else:
            out[name] = _to_numpy(v)
    return out


def block_state_from_numpy(arrays: Mapping[str, Any], device="cuda") -> BlockState:
    """A port ``BlockState`` on ``device`` (the card by default, a
    ``RuntimeError`` where there is none) from a mapping of every
    BlockState field to numpy arrays (``model_points`` /
    ``model_normals``: a sequence of per-level arrays), e.g. a JAX
    ``BlockState._asdict()``.  ``color`` is the [C+1,B,B,B,3] pool of a
    ``use_color`` map or the [1,1,1,1,3] dummy, in the pool dtype."""
    return _state_from_numpy(BlockState, arrays, device)


def block_state_to_numpy(state: BlockState) -> Dict[str, Any]:
    """Every field of a port ``BlockState`` as numpy arrays (model maps
    as tuples of per-level arrays); bfloat16 pools widen to float32."""
    return _state_to_numpy(state)


# Fields of a sharded state whose dim 0 stacks the shards' local arrays;
# the others are replicated.  ``color`` is stacked only with a color pool.
_SHARDED_FIELDS = ("bucket_keys", "bucket_slots", "block_coords", "tsdf", "weight",
                   "num_blocks", "vis_slots", "color")


def _stacked(name: str, arrays: Mapping[str, Any]) -> bool:
    if name == "color":
        return np.shape(arrays["color"])[0] == np.shape(arrays["tsdf"])[0]
    return name in _SHARDED_FIELDS


def sharded_block_state_from_numpy(
    arrays: Mapping[str, Any], rank: int, ns: int, device="cuda"
) -> BlockState:
    """Shard ``rank``'s local ``BlockState`` of a ``ns``-shard map on
    ``device`` (the card by default, a ``RuntimeError`` where there is
    none), from the global arrays of a JAX ``ShardedBlockPipeline``
    state (``state._asdict()``): dim 0 of every map array, of
    ``num_blocks`` and of ``vis_slots`` stacks the ``ns`` shards' local
    arrays; pose, model maps and counters are replicated."""
    return block_state_from_numpy(_local_arrays(arrays, rank, ns), device)


def _local_arrays(arrays: Mapping[str, Any], rank: int, ns: int) -> Dict[str, Any]:
    """Shard ``rank``'s slice of a sharded state's global arrays."""
    local = {}
    for name in BlockState._fields:
        v = arrays[name]
        if _stacked(name, arrays):
            a = np.asarray(v)
            n = a.shape[0] // ns
            v = a[rank * n : (rank + 1) * n]
            if name == "num_blocks":
                v = v.reshape(())
        local[name] = v
    return local


def sharded_block_state_to_numpy(states) -> Dict[str, Any]:
    """The global layout of a sharded state (as a JAX
    ``ShardedBlockPipeline`` state holds it) from every shard's local
    state in rank order: port ``BlockState``s, or their
    ``block_state_to_numpy`` dicts.  Replicated fields come from rank 0."""
    parts = [s if isinstance(s, Mapping) else block_state_to_numpy(s) for s in states]
    out = dict(parts[0])
    for name in BlockState._fields:
        if _stacked(name, parts[0]):
            out[name] = np.concatenate([np.atleast_1d(p[name]) for p in parts])
    return out


def dense_state_from_numpy(arrays: Mapping[str, Any], device="cuda") -> DenseState:
    """A port ``DenseState`` on ``device`` (the card by default, a
    ``RuntimeError`` where there is none) from a mapping of every
    DenseState field to numpy arrays, e.g. a JAX ``DenseState._asdict()``.
    ``color`` is the [D0,D1,D2,3] grid of a ``use_color`` volume or the
    [1,1,1,3] dummy."""
    return _state_from_numpy(DenseState, arrays, device)


def dense_state_to_numpy(state: DenseState) -> Dict[str, Any]:
    """Every field of a port ``DenseState`` as numpy arrays (model maps
    as tuples of per-level arrays)."""
    return _state_to_numpy(state)


def pose_graph_from_numpy(arrays: Mapping[str, Any], device="cuda") -> PoseGraph:
    """A port ``PoseGraph`` on ``device`` (the card by default, a
    ``RuntimeError`` where there is none) from a mapping of every
    PoseGraph field to numpy arrays, e.g. a JAX ``PoseGraph._asdict()``."""
    return _state_from_numpy(PoseGraph, arrays, device)


def pose_graph_to_numpy(pg: PoseGraph) -> Dict[str, Any]:
    """Every field of a port ``PoseGraph`` as numpy arrays."""
    return _state_to_numpy(pg)


def _as_numpy(x) -> np.ndarray:
    """A torch tensor or any array (a JAX array, say) as numpy."""
    return _to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields_numpy(nt) -> Dict[str, Any]:
    return {k: (tuple(_as_numpy(x) for x in v) if isinstance(v, tuple) else _as_numpy(v))
            for k, v in nt._asdict().items()}


def _host_values(src) -> Dict[str, Any]:
    """A SLAM system's host bookkeeping, copied."""
    return {
        "odom_poses": [np.array(T) for T in src["odom_poses"]],
        "kf_odom_poses": [np.array(T) for T in src["kf_odom_poses"]],
        "kf_for_frame": list(src["kf_for_frame"]),
        "frame_idx": int(src["frame_idx"]),
        "loops_closed": int(src["loops_closed"]),
        "reintegrations": int(src["reintegrations"]),
    }


def slam_state_to_numpy(slam) -> Dict[str, Any]:
    """What a SLAM system carries between chunks, as numpy and Python
    values: ``state`` and ``graph`` (field dicts), ``kf_depth_buf``,
    ``kf_odom_buf``, ``ring`` (depths, poses, latest keyframe; None without
    a ring) and the host lists and counters.  ``slam`` is a port
    ``SlamSystem`` or any object with the same attributes (a JAX
    ``SlamSystem``)."""
    out = {
        "state": _fields_numpy(slam.state),
        "graph": _fields_numpy(slam.graph),
        "kf_depth_buf": _as_numpy(slam.kf_depth_buf),
        "kf_odom_buf": _as_numpy(slam.kf_odom_buf),
        "ring": (tuple(_as_numpy(x) for x in (slam.ring_depths, slam.ring_poses, slam.ring_kf))
                 if slam.R > 0 else None),
    }
    out.update(_host_values(vars(slam)))
    return out


def slam_state_from_numpy(values: Mapping[str, Any], slam) -> None:
    """Carry ``values`` (as ``slam_state_to_numpy`` returns them, from
    either package) into the port ``SlamSystem`` ``slam``, on its device;
    its configuration must have the same capacities."""
    dev = slam.device
    slam.state = block_state_from_numpy(values["state"], dev)
    slam.graph = pose_graph_from_numpy(values["graph"], dev)
    slam.kf_depth_buf = _to_tensor(values["kf_depth_buf"], dev)
    slam.kf_odom_buf = _to_tensor(values["kf_odom_buf"], dev)
    if (values["ring"] is None) != (slam.R == 0):
        raise ValueError("one system has a re-integration ring and the other not")
    if slam.R > 0:
        slam.ring_depths, slam.ring_poses, slam.ring_kf = (
            _to_tensor(x, dev) for x in values["ring"])
    for name, v in _host_values(values).items():
        setattr(slam, name, v)


def _store_numpy(store) -> Dict[tuple, tuple]:
    return {k: tuple(None if a is None else _as_numpy(a) for a in v) for k, v in store.items()}


def sharded_slam_state_to_numpy(slam) -> Dict[str, Any]:
    """``slam_state_to_numpy`` of a sharded SLAM system, with its host
    cache under ``swap`` (None without one): ``stores`` (one coord-keyed
    dict of numpy payloads per shard, in insertion order), ``last_seen``
    ([shards, local capacity]) and ``clock``.  ``slam`` is a JAX
    ``ShardedSlamSystem`` (the whole map and every shard's store) or one
    shard's port ``ShardedSlamSystem`` (its local map and store; put the
    shards together with ``gather_sharded_slam_state``)."""
    out = slam_state_to_numpy(slam)
    sw = slam.swap
    out["swap"] = None if sw is None else dict(
        stores=[_store_numpy(st) for st in (sw.stores if hasattr(sw, "stores") else [sw.store])],
        last_seen=np.atleast_2d(np.array(sw.last_seen)),
        clock=int(sw._frame),
    )
    return out


def gather_sharded_slam_state(parts) -> Dict[str, Any]:
    """The global values of a sharded SLAM system, as a JAX
    ``ShardedSlamSystem`` holds them, from every shard's
    ``sharded_slam_state_to_numpy`` in rank order: the map in the global
    layout, the stores and recency rows stacked, the replicated values
    from shard 0."""
    out = dict(parts[0])
    out["state"] = sharded_block_state_to_numpy([p["state"] for p in parts])
    if parts[0]["swap"] is not None:
        out["swap"] = dict(stores=[p["swap"]["stores"][0] for p in parts],
                           last_seen=np.concatenate([p["swap"]["last_seen"] for p in parts]),
                           clock=parts[0]["swap"]["clock"])
    return out


def sharded_slam_state_from_numpy(values: Mapping[str, Any], slam) -> None:
    """Carry the global values of a sharded SLAM system (as
    ``sharded_slam_state_to_numpy`` gives them for a JAX
    ``ShardedSlamSystem``) into this shard's port ``ShardedSlamSystem``:
    its slice of the map (``sharded_block_state_from_numpy``), the
    replicated graph, keyframe buffers, ring and host bookkeeping
    (``slam_state_from_numpy``), and its host cache's store, recency row
    and clock."""
    rank, ns = slam.axis.rank, slam.axis.size
    slam_state_from_numpy({**values, "state": _local_arrays(values["state"], rank, ns)}, slam)
    swap = values.get("swap")
    if (swap is None) != (slam.swap is None):
        raise ValueError("one system has a host cache and the other not")
    if swap is not None:
        slam.swap.store = {k: tuple(None if a is None else _to_tensor(a, "cpu") for a in v)
                           for k, v in swap["stores"][rank].items()}
        slam.swap.last_seen = np.array(swap["last_seen"][rank])
        slam.swap._frame = int(swap["clock"])
