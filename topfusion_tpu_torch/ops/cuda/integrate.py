"""Wrapper of the fused CUDA integrate kernel (``csrc/integrate.cu``).

The port of ``topfusion_tpu/ops/pallas/integrate_kernel.integrate_blocks_pallas``:
a drop-in for ``ops/tsdf_block.integrate_blocks``, which is its plain
PyTorch version.  On CPU tensors the wrapper runs that plain version; on
CUDA tensors it launches the kernel or raises (there is no fallback).

The kernel updates ``m.tsdf`` / ``m.weight`` IN PLACE, as the plain
version does.  It takes T_cw from a device tensor (no host sync); the
intrinsics and TSDF constants are passed as float32 arguments equal to
the scalars the plain version uses.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ...config import BlockMapConfig, CameraConfig, TSDFConfig
from ...geometry.se3 import se3_inverse
from .. import tsdf_block
from ..blockmap import POOL_I16_SCALE, BlockMap
from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.bfloat16: 2}

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]          # tsdf, weight, dtype
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]                  # slots, coords, mask, V
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]           # depth, h, w
    + [ctypes.c_void_p, ctypes.c_int]                         # T_cw, bsz
    + [ctypes.c_float] * 10                                   # fx..i16_inv_scale
    + [ctypes.c_int, ctypes.c_void_p]                         # stop_at_max, stream
)


def _lib():
    lib = load_library("integrate")
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
    _check(bsz ** 3 <= 1024, "block_size^3 must fit one CTA (<= 1024 threads)")
    _check(slots.dtype == torch.int32 and tuple(slots.shape) == (V,), "slots must be [V] int32")
    _check(coords.dtype == torch.int32 and tuple(coords.shape) == (V, 3), "coords must be [V, 3] int32")
    _check(mask.dtype == torch.bool and tuple(mask.shape) == (V,), "mask must be [V] bool")
    _check(T_wc.dtype == torch.float32 and tuple(T_wc.shape) == (4, 4), "T_wc must be [4, 4] float32")

    num_visible = torch.sum(mask, dtype=torch.int32)
    if V == 0:  # an empty grid is not a launch
        return m, num_visible
    T_cw = se3_inverse(T_wc).contiguous()
    h, w = depth.shape
    with torch.cuda.device(dev):
        err = _lib()(
            m.tsdf.data_ptr(), m.weight.data_ptr(), _DTYPE_CODE[m.tsdf.dtype],
            slots.data_ptr(), coords.data_ptr(), mask.data_ptr(), V,
            depth.data_ptr(), h, w, T_cw.data_ptr(), bsz,
            _f32(cam.fx), _f32(cam.fy), _f32(cam.cx), _f32(cam.cy),
            _f32(tsdf_cfg.voxel_size), _f32(tsdf_cfg.trunc_dist),
            _f32(tsdf_cfg.max_weight), _f32(tsdf_cfg.view_frustum_min),
            _f32(tsdf_cfg.view_frustum_max), _f32(1.0 / POOL_I16_SCALE),
            int(tsdf_cfg.stop_integrating_at_max_weight),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"integrate kernel launch failed: CUDA error {err}")
    integrate_blocks_cuda.launches += 1
    return m, num_visible


# Launches of the kernel in this process (the plain CPU path is not a
# launch).  Callers zero it before a run and read it after.
integrate_blocks_cuda.launches = 0
