# Frozen copy of topfusion_tpu_torch/utils/device_info.py at commit 81038a6, the yardstick's plain reference,
# trimmed to entry_device (the banners left out).
"""The device an entry point runs on."""

from __future__ import annotations

import torch


def entry_device(device="cuda") -> torch.device:
    """The device an entry point of the port runs on: the card, unless
    the caller names another (the tests name the CPU).  Raises where the
    card is asked for, by default or by name, and there is none: an entry
    point never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (it is the default) but "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "on the CPU"
        )
    return dev
