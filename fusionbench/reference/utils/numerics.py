# Frozen copy of topfusion_tpu_torch/utils/numerics.py at commit 81038a6, the yardstick's plain reference.
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


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of 3, as ``sqrt((x*x + y*y) + z*z)``
    with one rounding per operation, so the CPU and the card give the
    same bits (a library reduction promises no order)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def vec(values, device, dtype=torch.float32) -> torch.Tensor:
    """A short vector of Python numbers as a tensor made ON ``device``, one
    fill per element: ``torch.tensor(values, device="cuda")`` would copy
    from the host, which synchronizes."""
    return torch.cat([torch.full((1,), v, dtype=dtype, device=device) for v in values])


def linspace01(k: int, device) -> torch.Tensor:
    """The float32 values the JAX package's ``jnp.linspace(0, 1, k)``
    takes: ``i * float32(1/(k-1))`` for i < k-1 (XLA multiplies by the
    reciprocal), then exactly 1.  ``torch.linspace`` and a true division
    are each an ulp off for some k (4 and 7); this form equals
    ``jnp.linspace`` for every k below 3000.  Built on the device, since
    copying a host array there would synchronize."""
    one = torch.ones(1, dtype=torch.float32, device=device)
    if k == 1:
        return one * 0.0
    i = torch.arange(k - 1, dtype=torch.float32, device=device)
    return torch.cat([i * (1.0 / (k - 1)), one])
