"""Checkpoint save/load for fusion state and pose graphs (port of
``topfusion_tpu/utils/checkpoint.py``).

A state (a NamedTuple of tensors, tuples of tensors allowed: BlockState,
DenseState, PoseGraph) is one compressed ``.npz`` of its leaves in JAX's
pytree order (fields in order, tuples flattened in place), named
``leaf_0``, ``leaf_1``, ..., so a file written by either package loads
into the other.  numpy has no bfloat16: a bfloat16 leaf is written widened
to float32 (exact) and narrowed again on load.  Trajectories export in
TUM format.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Sequence, TypeVar

import numpy as np
import torch

from ..io.trajectory import save_tum_trajectory

T = TypeVar("T")


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a NamedTuple / tuple tree in JAX's leaf order (None
    is no leaf)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [leaf for child in tree for leaf in _leaves(child)]


def _rebuild(like, leaves):
    """``like``'s tree with its tensors replaced, in order, from the
    iterator ``leaves``."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if like is None:
        return None
    children = [_rebuild(child, leaves) for child in like]
    return type(like)(*children) if hasattr(like, "_fields") else type(like)(children)


def save_state(path: str, state: Any) -> None:
    """Serialize a NamedTuple of tensors (tuples of tensors allowed)."""
    arrays = {}
    for i, x in enumerate(_leaves(state)):
        x = x.detach().cpu()
        arrays[f"leaf_{i}"] = (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __treedef__=type(state).__name__, **arrays)


def load_state(path: str, like: T) -> T:
    """Restore a state saved by either package's ``save_state``; ``like``
    gives the tree, dtypes and device (shapes must match the saved
    config)."""
    with np.load(path, allow_pickle=False) as data:
        loaded = []
        for i, ref in enumerate(_leaves(like)):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != expected "
                    f"{tuple(ref.shape)}: config mismatch"
                )
            if arr.dtype.name == "bfloat16" or (
                    arr.dtype.kind == "V" and arr.dtype.itemsize == 2
                    and ref.dtype == torch.bfloat16):
                # JAX's bfloat16 leaf: ml_dtypes' dtype, or raw 2-byte
                # records where numpy does not know it.
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            loaded.append(t.to(device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(loaded))


def save_run(
    out_dir: str,
    state: Any,
    odom_poses: Sequence[np.ndarray],
    optimized_poses: Sequence[np.ndarray] | None = None,
    timestamps: Sequence[float] | None = None,
    metrics: dict | None = None,
) -> None:
    """Persist a full run: map/pose state + TUM trajectories + metrics."""
    os.makedirs(out_dir, exist_ok=True)
    save_state(os.path.join(out_dir, "state.npz"), state)
    save_tum_trajectory(
        os.path.join(out_dir, "trajectory_odom.txt"), odom_poses, timestamps
    )
    if optimized_poses is not None:
        save_tum_trajectory(
            os.path.join(out_dir, "trajectory_opt.txt"),
            optimized_poses,
            timestamps,
        )
    if metrics is not None:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
