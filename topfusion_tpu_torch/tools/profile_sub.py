"""Sub-stage timing: the preprocessing and splat internals of the step
(port of ``scripts/profile_sub.py``).

The bench configuration on the state after 2 frames of the orbit, as
``tools/profile_stages.py`` builds it; rows and columns as there.

Usage:  python3 -m topfusion_tpu_torch.tools.profile_sub [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def run(cfg, device, n: int = 10):
    """Every row on the state ``tools/profile_stages.prepare`` builds
    from ``cfg``; returns the Timer."""
    from ..ops.depth import bilateral_filter, depth_to_meters, downsample_depth, preprocess_depth
    from ..ops.splat import splat_model_maps
    from .profile_stages import prepare
    from .timing import Timer

    x = prepare(cfg, device)
    cam, tc, bm, rc = cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast
    timer = Timer(device, n=n, width=40)
    print(timer.header())
    d_m = timer.row("depth_to_meters", depth_to_meters, x.depth_mm)
    timer.row("bilateral 7x7", bilateral_filter, d_m)
    timer.row("downsample L1", downsample_depth, d_m)
    timer.row("preprocess full", lambda d: preprocess_depth(d, cfg.preproc), x.depth_mm)
    timer.row("splat NEW", lambda m, T, v: splat_model_maps(
        m, cam, tc, bm, T, v, surfels_per_block=rc.surfels_per_block,
        dilate_passes=rc.dilate_passes), x.m, x.T, x.vis)
    timer.row("FULL step", x.pipe.step, x.state, x.depth_mm)
    return timer


def main(argv=None) -> int:
    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .bench_config import bench_config
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    if device.type == "cuda":
        print(nvidia_smi_name_power())
    run(bench_config(), device)
    return 0

if __name__ == "__main__":
    sys.exit(main())
