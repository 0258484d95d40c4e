"""Device banner of the port: torch and CUDA versions, the card, and the
card's power limit (a card set below its maximum runs slower under load,
so every timing is reported beside it)."""

from __future__ import annotations

import shutil
import subprocess

import torch


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


def device_banner() -> str:
    """torch version, torch.version.cuda, the CUDA devices, and the
    nvidia-smi name and power limit."""
    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            lines.append(f"  [cuda:{i}] {torch.cuda.get_device_name(i)}")
        lines.append(nvidia_smi_name_power())
    else:
        lines.append("  no CUDA device")
    return "\n".join(lines)
