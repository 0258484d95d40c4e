"""Peaks of one NVIDIA H100 (SXM, 700 W; NVIDIA's data sheet) and the
integrate kernel's bound.

Frozen copy of ``chip_smoke.py``'s ``integrate_bound`` and its constants
at commit 81038a6.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
INTEGRATE_OPS_PER_VOXEL = 40  # float operations per voxel of a live entry
INTEGRATE_KERNEL = "integrate_columns_kernel"


def integrate_bound(updated: int, live_voxels: int, elem_size: int, h: int, w: int,
                    num_entries: int) -> dict:
    """The least time the card could take for one integrate call: the
    larger of the bytes it must move (each updated voxel's tsdf and weight
    read once and written once, the depth image, the visible lists and the
    pose read once) over the memory rate, and its float operations (every
    voxel of a live entry is projected and gated) over the float32 rate."""
    nbytes = updated * 4 * elem_size + h * w * 4 + num_entries * (4 + 12 + 1) + 64
    ops = live_voxels * INTEGRATE_OPS_PER_VOXEL
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms}
