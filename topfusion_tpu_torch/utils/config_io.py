"""Config serialization + CLI overrides (a copy of
``topfusion_tpu/utils/config_io.py`` over the port's config classes: the
JAX module imports ``topfusion_tpu.config``, which loads jax).

The reference hard-codes everything (SURVEY.md section 5.6); here any
``PipelineConfig`` round-trips through YAML/JSON and accepts dotted CLI
overrides (``--set tsdf.voxel_size=0.01``), with capacities as plain
runtime config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from .. import config as cfg_mod
from ..config import PipelineConfig


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _build(cls, data: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and hasattr(cfg_mod, f.type)
        ):
            sub_cls = f.type if dataclasses.is_dataclass(f.type) else getattr(cfg_mod, f.type)
            kwargs[f.name] = _build(sub_cls, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def from_dict(data: Dict[str, Any]) -> PipelineConfig:
    return _build(PipelineConfig, data)


def save_config(path: str, cfg: PipelineConfig) -> None:
    data = to_dict(cfg)
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(data, f, sort_keys=False)
    else:
        with open(path, "w") as f:
            json.dump(data, f, indent=2)


def load_config(path: str) -> PipelineConfig:
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
    else:
        with open(path) as f:
            data = json.load(f)
    return from_dict(data)


def apply_overrides(cfg: PipelineConfig, overrides) -> PipelineConfig:
    """Apply dotted-path overrides like ``tsdf.voxel_size=0.004`` or
    ``icp.iters=10,5,4``."""
    data = to_dict(cfg)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override '{ov}' must be key=value")
        node = data
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key: {key}")
        old = node[leaf]
        node[leaf] = _parse_value(raw.strip(), old)
    return from_dict(data)


def _parse_value(raw: str, old: Any) -> Any:
    if old is None:
        # Tri-state fields (e.g. use_pallas_integrate: None = auto).
        low = raw.lower()
        if low in ("none", "null", "auto"):
            return None
        if low in ("1", "true", "yes", "on", "0", "false", "no", "off"):
            return low in ("1", "true", "yes", "on")
        return raw
    if isinstance(old, (tuple, list)):
        return tuple(
            _parse_value(x, old[0] if len(old) else 0) for x in raw.split(",")
        )
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int):
        return int(raw, 0)
    if isinstance(old, float):
        return float(raw)
    return raw
