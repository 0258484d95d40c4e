"""Carry configs and state between the JAX package and the port, without
importing jax.

The system has no weights: what must carry across is the config tree and
the fusion state (hash table and voxel pool or dense volume, color, pose,
model maps, visible list, counters), so that a state reached by one
package can be stepped, rendered and exported by the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import PipelineConfig
from .models.block_pipeline import BlockState
from .models.pipeline import DenseState
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
