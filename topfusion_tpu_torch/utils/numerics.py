"""Float32 arithmetic helpers that keep the port's results the same on
the CPU and on the card.

PyTorch's CUDA ``tensor / python_scalar`` multiplies by the scalar's
reciprocal (one rounding more than a division), and ``python_scalar /
tensor`` does so on every device.  The JAX package and the CUDA kernels
divide; ``true_div`` divides by a 0-d tensor on the operand's device,
which both backends compute as an IEEE division.
"""

from __future__ import annotations

import torch


def true_div(a, b):
    """IEEE float32 ``a / b`` where one side may be a Python number."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)
