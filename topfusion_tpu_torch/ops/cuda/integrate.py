"""Wrapper of the fused CUDA integrate kernel (``csrc/integrate.cu``).

The port of ``topfusion_tpu/ops/pallas/integrate_kernel.integrate_blocks_pallas``:
a drop-in for ``ops/tsdf_block.integrate_blocks``, which is its plain
PyTorch version.  On CPU tensors the wrapper runs that plain version; on
CUDA tensors it launches the kernel or raises (there is no fallback).

The kernel updates ``m.tsdf`` / ``m.weight`` IN PLACE, as the plain
version does.  It takes T_wc from a device tensor (no host sync) and
inverts it itself, so on the card the wrapper launches two device
operations: the count of visible entries (one ``torch.sum``, which does
not depend on the kernel) and the kernel.  The intrinsics and TSDF
constants are passed as float32 arguments equal to the scalars the plain
version uses.

Two kernels share the source (``launch_plan``): blocks of 8^3 voxels,
what every configuration uses, take the column kernel (one thread per
16-byte z-column); any other block size with at most 1024 voxels takes
the per-voxel kernel.  ``integrate_blocks_cuda.launches`` counts both,
``integrate_blocks_cuda.vector_launches`` the column kernel's alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...config import BlockMapConfig, CameraConfig, TSDFConfig
from ...utils import counters
from .. import tsdf_block
from ..blockmap import POOL_I16_SCALE, BlockMap
from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.bfloat16: 2}

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]          # tsdf, weight, dtype
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]                  # slots, coords, mask, V
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]           # depth, h, w
    + [ctypes.c_void_p, ctypes.c_int]                         # T_wc, bsz
    + [ctypes.c_int, ctypes.c_int]                            # grid, block
    + [ctypes.c_float] * 10                                   # fx..i16_inv_scale
    + [ctypes.c_int, ctypes.c_void_p]                         # stop_at_max, stream
)


# The column kernel: blocks of COLUMN_BLOCK_SIZE^3 voxels, one thread per
# z-column (COLUMN_BLOCK_SIZE voxels, contiguous in the pool), so
# COLUMN_BLOCK_SIZE^2 threads per visible entry.
COLUMN_BLOCK_SIZE = 8
COLUMN_THREADS_PER_ENTRY = COLUMN_BLOCK_SIZE ** 2
# Entries per CTA.  On an H100 (tools/integrate_sweep.py; int16 pool, bench
# list, L2 flushed) CTAs of 128 threads took 11.0 us against 11.2 us at
# 256 threads, 12.6 us at 512 and 14.2 us at 1024.
COLUMN_ENTRIES_PER_CTA = 2
MAX_CTA_THREADS = 1024


class LaunchPlan(NamedTuple):
    """Which kernel serves a visible list and at what grid.  CTA ``c``
    serves entries ``c * entries_per_cta + i`` for ``i`` below
    ``entries_per_cta``; the kernel skips those not below the list's
    length.  ``grid`` 0 means there is nothing to launch."""

    path: str            # "column" or "voxel"
    grid: int            # CTAs
    block: int           # threads per CTA
    entries_per_cta: int


def launch_plan(num_entries: int, block_size: int) -> LaunchPlan:
    """The launch for ``num_entries`` visible entries of ``block_size``^3
    voxels: the column kernel for ``COLUMN_BLOCK_SIZE``, else the
    per-voxel kernel, one CTA of ``block_size``^3 threads per entry."""
    if num_entries < 0:
        raise ValueError(f"integrate_blocks_cuda: {num_entries} visible entries")
    if block_size == COLUMN_BLOCK_SIZE:
        per_cta = COLUMN_ENTRIES_PER_CTA
        return LaunchPlan("column", -(-num_entries // per_cta),
                          per_cta * COLUMN_THREADS_PER_ENTRY, per_cta)
    if not 1 <= block_size ** 3 <= MAX_CTA_THREADS:
        raise ValueError(
            f"integrate_blocks_cuda: block_size^3 = {block_size ** 3} must fit "
            f"one CTA (<= {MAX_CTA_THREADS} threads)")
    return LaunchPlan("voxel", num_entries, block_size ** 3, 1)


def bind_entry_point(lib: ctypes.CDLL):
    """``tf_integrate_blocks`` of a built library, with its C signature."""
    fn = lib.tf_integrate_blocks
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _f32(x: float) -> float:
    """The float32 value the plain path's scalar ``x`` takes."""
    return float(np.float32(x))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"integrate_blocks_cuda: {what}")


def launch_kernel(fn, m, cam, tsdf_cfg, bm_cfg, T_wc, depth, vis, plan: LaunchPlan) -> None:
    """Call the C entry point ``fn`` on checked CUDA tensors, on the
    current stream of their device; raises if the launch is refused."""
    slots, coords, mask = vis
    h, w = depth.shape
    dev = depth.device
    with torch.cuda.device(dev):
        err = fn(
            m.tsdf.data_ptr(), m.weight.data_ptr(), _DTYPE_CODE[m.tsdf.dtype],
            slots.data_ptr(), coords.data_ptr(), mask.data_ptr(), slots.shape[0],
            depth.data_ptr(), h, w, T_wc.data_ptr(), bm_cfg.block_size,
            plan.grid, plan.block,
            _f32(cam.fx), _f32(cam.fy), _f32(cam.cx), _f32(cam.cy),
            _f32(tsdf_cfg.voxel_size), _f32(tsdf_cfg.trunc_dist),
            _f32(tsdf_cfg.max_weight), _f32(tsdf_cfg.view_frustum_min),
            _f32(tsdf_cfg.view_frustum_max), _f32(1.0 / POOL_I16_SCALE),
            int(tsdf_cfg.stop_integrating_at_max_weight),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err == 1:  # cudaErrorInvalidValue, from the entry point's own checks
        raise ValueError(
            "integrate_blocks_cuda: the kernel takes |fx|, |fy|, trunc_dist and the "
            "view frustum between 1e-6 and 1e6, and |cx|, |cy|, max_weight up to 1e6")
    if err != 0:
        raise RuntimeError(f"integrate kernel launch failed: CUDA error {err}")


def integrate_blocks_cuda(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: torch.Tensor,
    depth: torch.Tensor,
    vis: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> Tuple[BlockMap, torch.Tensor]:
    """Fuse one depth image [H, W] (float32 meters) into the visible
    blocks ``vis = (slots [V] i32, coords [V, 3] i32, mask [V] bool)``.
    Returns (map, num_visible)."""
    if depth.device.type == "cpu":
        return tsdf_block.integrate_blocks(
            m, cam, tsdf_cfg, bm_cfg, T_wc, depth, vis
        )
    _check(depth.device.type == "cuda", f"unsupported device {depth.device}")
    slots, coords, mask = vis
    dev = depth.device
    V = slots.shape[0]
    bsz = bm_cfg.block_size
    pool_shape = (m.capacity + 1, bsz, bsz, bsz)
    for name, t in (("tsdf", m.tsdf), ("weight", m.weight), ("slots", slots),
                    ("coords", coords), ("mask", mask), ("T_wc", T_wc)):
        _check(t.device == dev, f"{name} is on {t.device}, depth on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(depth.is_contiguous(), "depth must be contiguous")
    _check(depth.dtype == torch.float32 and depth.ndim == 2, "depth must be [H, W] float32")
    _check(m.tsdf.dtype == m.weight.dtype, "tsdf and weight pools differ in dtype")
    _check(m.tsdf.dtype in _DTYPE_CODE, f"pool dtype {m.tsdf.dtype} not supported")
    _check(tuple(m.tsdf.shape) == pool_shape and tuple(m.weight.shape) == pool_shape,
           f"pools must be {pool_shape}")
    plan = launch_plan(V, bsz)
    if plan.path == "column":  # 16-byte accesses
        _check(m.tsdf.data_ptr() % 16 == 0 and m.weight.data_ptr() % 16 == 0,
               "pools must be 16-byte aligned")
    _check(slots.dtype == torch.int32 and tuple(slots.shape) == (V,), "slots must be [V] int32")
    _check(coords.dtype == torch.int32 and tuple(coords.shape) == (V, 3), "coords must be [V, 3] int32")
    _check(mask.dtype == torch.bool and tuple(mask.shape) == (V,), "mask must be [V] bool")
    _check(T_wc.dtype == torch.float32 and tuple(T_wc.shape) == (4, 4), "T_wc must be [4, 4] float32")

    num_visible = torch.sum(mask, dtype=torch.int32)
    if plan.grid == 0:  # an empty grid is not a launch
        return m, num_visible
    launch_kernel(bind_entry_point(load_library("integrate")), m, cam, tsdf_cfg, bm_cfg, T_wc, depth, vis, plan)
    integrate_blocks_cuda.launches += 1
    if plan.path == "column":
        integrate_blocks_cuda.vector_launches += 1
    return m, num_visible


# Launches of either kernel in this process, and of the column kernel
# alone (the plain CPU path is not a launch).  Callers zero them before a
# run and read them after.
integrate_blocks_cuda.launches = 0
integrate_blocks_cuda.vector_launches = 0
counters.register(integrate_blocks_cuda, "integrate_blocks_cuda", "launches", "vector_launches")
