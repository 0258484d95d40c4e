"""Device banner of the port: torch and CUDA versions, the card, and the
card's power limit (a card set below its maximum runs slower under load,
so every timing is reported beside it)."""

from __future__ import annotations

import shutil
import subprocess

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


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of every card, one line
    each, or a note that nvidia-smi is missing or failed."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        return f"nvidia-smi failed ({res.returncode}): {res.stderr.strip()}"
    return res.stdout.strip()


def device_banner(verbose: bool = False) -> str:
    """torch version, torch.version.cuda, the CUDA devices, and the
    nvidia-smi name and power limit; ``verbose`` adds each card's compute
    capability, memory and multiprocessor count."""
    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            desc = f"  [cuda:{i}] {torch.cuda.get_device_name(i)}"
            if verbose:
                p = torch.cuda.get_device_properties(i)
                desc += (f" (sm_{p.major}{p.minor}, {p.total_memory / 2**30:.1f} GiB, "
                         f"{p.multi_processor_count} multiprocessors)")
            lines.append(desc)
        lines.append(nvidia_smi_name_power())
    else:
        lines.append("  no CUDA device")
    return "\n".join(lines)


def mesh_banner(axis) -> str:
    """The map axis (``parallel.collectives.MapAxis``): its size and
    backend, each rank's device, and the cards' names and power limits.  Every member of the axis calls it (it gathers the
    ranks' devices)."""
    import torch.distributed as dist

    devices = [None] * axis.size
    dist.all_gather_object(devices, str(axis.device), group=axis.group)
    ranks = ", ".join(f"{r} -> {d}" for r, d in enumerate(devices))
    lines = [f"map axis: {axis.size} shard(s) over {axis.backend}; "
             f"rank -> device: {ranks}"]
    if any(d.startswith("cuda") for d in devices):
        lines.append(nvidia_smi_name_power())
    return "\n".join(lines)


def print_device_info(verbose: bool = False) -> None:
    """Print ``device_banner()``; ``verbose`` adds each card's compute
    capability, memory and multiprocessor count."""
    print(device_banner(verbose))
