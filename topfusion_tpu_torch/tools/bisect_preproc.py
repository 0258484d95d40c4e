"""Bisect ``preprocess_depth``'s cost: which sub-op of the 49-tap
bilateral filter burns the time (port of ``scripts/bisect_preproc.py``).

A 480x640 float32 image |N(0, 1)| + 0.5 from ``torch.Generator`` seed 0;
rows and columns as ``tools/profile_stages.py``'s.

Usage:  python3 -m topfusion_tpu_torch.tools.bisect_preproc [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def stencil_only(d):
    """Raw stencil without exp: 49 shifted adds."""
    import torch

    from ..ops.depth import _shifted

    acc = torch.zeros_like(d)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            acc = acc + _shifted(d, dy, dx)
    return acc


def stencil_exp(d):
    """The same with exp weights."""
    import torch

    from ..ops.depth import _shifted

    acc = torch.zeros_like(d)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            nb = _shifted(d, dy, dx)
            acc = acc + torch.exp(-(d - nb) ** 2) * nb
    return acc


def exp49(d):
    """exp alone, x49."""
    import torch

    acc = torch.zeros_like(d)
    for i in range(49):
        acc = acc + torch.exp(-d * (1.0 + i))
    return acc


def stencil_roll(d):
    """Roll-based shifts instead of pad + slice."""
    import torch

    acc = torch.zeros_like(d)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            acc = acc + torch.roll(d, (dy, dx), (0, 1))
    return acc


def stencil_v(d):
    """Vertical-only shifts."""
    import torch

    from ..ops.depth import _shifted

    acc = torch.zeros_like(d)
    for dy in range(-3, 4):
        for _ in range(7):
            acc = acc + _shifted(d, dy, 0)
    return acc


def stencil_h(d):
    """Horizontal-only shifts."""
    import torch

    from ..ops.depth import _shifted

    acc = torch.zeros_like(d)
    for dx in range(-3, 4):
        for _ in range(7):
            acc = acc + _shifted(d, 0, dx)
    return acc


def run(device, n: int = 10):
    """Every row on the 480x640 image; returns the Timer."""
    import torch

    from ..ops.depth import bilateral_filter, depth_to_meters, downsample_depth
    from .timing import Timer

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((480, 640), generator=gen).abs() + 0.5).to(device)
    timer = Timer(device, n=n, width=32)
    print(timer.header())
    timer.row("depth_to_meters", depth_to_meters, x * 1000)
    timer.row("bilateral 7x7", bilateral_filter, x)
    timer.row("bilateral 5x5", lambda d: bilateral_filter(d, 5), x)
    timer.row("downsample", downsample_depth, x)
    timer.row("49-tap shifted sum (no exp)", stencil_only, x)
    timer.row("49-tap shifted exp sum", stencil_exp, x)
    timer.row("49 exps, no shifts", exp49, x)
    timer.row("49-tap roll sum", stencil_roll, x)
    timer.row("49-tap vertical-only shifts", stencil_v, x)
    timer.row("49-tap horizontal-only shifts", stencil_h, x)
    return timer


def main(argv=None) -> int:
    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    if device.type == "cuda":
        print(nvidia_smi_name_power())
    run(device)
    return 0

if __name__ == "__main__":
    sys.exit(main())
