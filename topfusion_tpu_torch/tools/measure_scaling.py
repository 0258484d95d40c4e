"""Scaling of the sharded block pipeline (port of
``scripts/measure_scaling.py``): a command line over
``parallel/multihost.measure_scaling_block``.

Weak scaling (each shard's working set held, BASELINE.md config 4) and
strong scaling (the global problem held, config 5) over the world sizes
1, 2, 4, 8 that ``--devices`` allows: one process per shard, NCCL where
every process has a card of its own, else gloo processes sharing the
cards (then no efficiency is computed: that measures overhead and one
host's contention, not scaling).  Prints one JSON line per mode.

Usage:  python3 -m topfusion_tpu_torch.tools.measure_scaling [--devices N] [--device cpu | --cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def scaling_config():
    """The JAX script's configuration: 320x240, 5 mm voxels, 2^13 blocks."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )

    cam = CameraConfig(width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=5),
        icp=ICPConfig(iters=(8, 4, 2)),
        tsdf=TSDFConfig(voxel_size=0.005, trunc_dist=0.02),
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
        ),
        raycast=RaycastConfig(max_steps=96),
    )


def run(cfg, device, counts, n_frames: int = 6) -> None:
    """One JSON line per mode over the world sizes ``counts``, ``n_frames``
    frames per timed pass."""
    from ..parallel.multihost import measure_scaling_block

    for mode in ("weak", "strong"):
        res = measure_scaling_block(cfg, n_frames=n_frames, device_counts=counts, mode=mode,
                                    device=device)
        print(json.dumps({str(k): (round(v, 3) if isinstance(v, float) else v)
                          for k, v in res.items()}), flush=True)


def main(argv=None) -> int:
    import torch

    from ..utils.device_info import entry_device
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, default=None,
                    help="largest world (default: the cards, or 8 processes on the CPU)")
    add_device_arg(ap)
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="the JAX script's flag: --device cpu")
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    n = args.devices or (max(torch.cuda.device_count(), 1) if device.type == "cuda" else 8)
    run(scaling_config(), device, [c for c in (1, 2, 4, 8) if c <= n])
    return 0

if __name__ == "__main__":
    sys.exit(main())
