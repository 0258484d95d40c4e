"""Wrapper of the batched 6x6 Jacobi eigensolver kernel (``csrc/eig6.cu``).

It computes ``ops/icp.obs_ratio``, the observability ratio lambda_min /
lambda_max of ICP Gram matrices that loop verification gates on.  The
JAX package takes it from ``jnp.linalg.eigvalsh`` in XLA
(``topfusion_tpu/ops/icp.py:395``); there is no Pallas kernel behind it.
The kernel exists because ``torch.linalg.eigvalsh`` synchronizes the
host on the card, and a CUDA graph cannot hold that.  Its plain PyTorch
twin is ``ops/icp.obs_ratio_plain`` (the same sweeps, pair order,
rotation and skip select in float64), bit for bit.

On CPU tensors the wrapper runs the twin; on CUDA tensors it launches
the kernel or raises (there is no fallback).  It allocates its output
with ``torch.empty`` on the input's device, launches on the current
stream, reads nothing back, and counts each launch in
``obs_ratio_cuda.launches`` (registered in ``utils/counters``, so a
captured graph counts its replays).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import counters
from .. import icp
from .build import load_library


def bind_entry_point(lib: ctypes.CDLL):
    """``tf_eig6_ratio`` of a built library, with its C signature."""
    fn = lib.tf_eig6_ratio
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(gram: torch.Tensor, with_eig: bool):
    if gram.device.type != "cuda":
        raise ValueError(f"obs_ratio_cuda: unsupported device {gram.device}")
    if gram.dtype != torch.float32 or gram.shape[-2:] != (6, 6):
        raise ValueError(f"obs_ratio_cuda: takes [..., 6, 6] float32, not "
                         f"{tuple(gram.shape)} {gram.dtype}")
    batch = gram.shape[:-2]
    g = gram.reshape(-1, 6, 6).contiguous()
    n = g.shape[0]
    ratio = torch.empty(n, dtype=torch.float32, device=g.device)
    eig = torch.empty((n, 6), dtype=torch.float64, device=g.device) if with_eig else None
    if n:
        fn = bind_entry_point(load_library("eig6"))
        with torch.cuda.device(g.device):
            err = fn(g.data_ptr(), n, ratio.data_ptr(), 0 if eig is None else eig.data_ptr(),
                     torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"eig6 kernel launch failed: CUDA error {err}")
        obs_ratio_cuda.launches += 1
    return ratio.reshape(batch), eig


def obs_ratio_cuda(gram: torch.Tensor) -> torch.Tensor:
    """lambda_min / lambda_max (float32, clamped as ``ops/icp.obs_ratio``
    states) of [..., 6, 6] float32 symmetric matrices: the kernel on a
    CUDA tensor, the plain twin on a CPU one."""
    if gram.device.type == "cpu":
        return icp.obs_ratio_plain(gram)
    return _launch(gram, with_eig=False)[0]


def eigvals_cuda(gram: torch.Tensor):
    """(ratio, ascending float64 eigenvalues [..., 6]) from one launch of
    the kernel on a CUDA tensor: what the card tests and ``chip_smoke.py``
    hold against the twin and ``torch.linalg.eigvalsh``."""
    ratio, eig = _launch(gram, with_eig=True)
    return ratio, torch.sort(eig, dim=-1).values.reshape(*gram.shape[:-2], 6)


# Launches of the kernel in this process (the plain CPU path is not a
# launch).  Callers zero it before a run and read it after.
obs_ratio_cuda.launches = 0
counters.register(obs_ratio_cuda, "obs_ratio_cuda", "launches")
