# Frozen copy of topfusion_tpu_torch/geometry/se3.py at commit 81038a6, the yardstick's plain reference.
"""SE(3) / SO(3) utilities on torch tensors (port of
``topfusion_tpu/geometry/se3.py``).

Conventions as in the JAX package: poses are 4x4 float matrices with
``p_out = T @ [p; 1]``; twists are 6-vectors ``[omega(3), v(3)]``; the
exp maps switch to Taylor series below ``theta^2 = 1e-3``.

``transform_points`` and ``rotate_vectors`` are written as explicit
per-component sums ``R[i,0]*x + R[i,1]*y + R[i,2]*z + t[i]`` (left to
right, one rounding per operation) instead of a matmul: the CUDA
integrate kernel computes the same expression with ``-fmad=false``, so
the plain path and the kernel agree to the bit on the card.
"""

from __future__ import annotations

import torch

from ..utils.numerics import true_div

_SMALL_THETA2 = 1e-3


def _hat(w: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix, batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _exp_coeffs(omega: torch.Tensor):
    """(theta2, small, theta2_safe, a, b) of the Rodrigues formula,
    shaped (..., 1, 1) for broadcasting against 3x3 matrices."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    small = theta2 < _SMALL_THETA2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - true_div(theta2, 6.0), torch.sin(theta) / theta)
    sinc_half = torch.sin(theta * 0.5) / (theta * 0.5)
    b = torch.where(small, 0.5 - true_div(theta2, 24.0), 0.5 * sinc_half * sinc_half)
    return theta2, small, theta2_safe, a, b


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with Taylor guard: omega (...,3) -> R (...,3,3)."""
    _, _, _, a, b = _exp_coeffs(omega)
    K = _hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * K + b * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [omega, v] (...,6) -> T (...,4,4)."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta2, small, theta2_safe, a, b = _exp_coeffs(omega)
    # V = I + b K + c K^2 with c = (1 - a)/theta^2, series 1/6 - theta^2/120
    c = torch.where(small, 1.0 / 6.0 - true_div(theta2, 120.0), (1.0 - a) / theta2_safe)
    K = _hat(omega)
    KK = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * KK
    V = eye + b * K + c * KK
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    return _append_bottom_row(top)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """R (...,3,3) -> omega (...,3), valid for theta < pi.  atan2(sin, cos)
    rather than arccos(trace), whose derivative is unbounded at the
    identity (the pose graph's Jacobians differentiate through this)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )  # = 2 sin(theta) * axis
    s2 = 0.25 * torch.sum(w * w, dim=-1, keepdim=True)      # sin^2(theta)
    c = torch.clamp((trace[..., None] - 1.0) * 0.5, -1.0, 1.0)  # cos(theta)
    small = s2 < _SMALL_THETA2
    s_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(s_safe, c)
    # theta / (2 sin theta); series in sin^2 near 0: 1/2 + s2/12.
    factor = torch.where(small, 0.5 + true_div(s2, 12.0), theta / (2.0 * s_safe))
    return factor * w


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T (...,4,4) -> twist [omega, v] (...,6).  Written without in-place
    operations, so ``torch.func.jacfwd`` and ``vmap`` trace it."""
    t = T[..., :3, 3]
    omega = so3_log(T[..., :3, :3])
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    small = theta2 < _SMALL_THETA2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - true_div(theta2, 6.0), torch.sin(theta) / theta)
    sinc_half = torch.sin(theta * 0.5) / (theta * 0.5)
    b = torch.where(small, torch.full_like(theta2, 0.5), 0.5 * sinc_half * sinc_half)
    K = _hat(omega)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - a/(2b)) K^2
    coef = torch.where(
        small,
        1.0 / 12.0 + true_div(theta2, 720.0),
        (1.0 - a / (2.0 * b)) / theta2_safe,
    )
    Vinv = eye - 0.5 * K + coef * (K @ K)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([omega, v], dim=-1)


def _append_bottom_row(top: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with the row [0, 0, 0, 1].  The row is
    made on the tensor's device (writing a Python scalar into a CUDA
    tensor would be a host-to-device copy, which synchronizes)."""
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def _apply_rows_xyz(M: torch.Tensor, x, y, z) -> list:
    """[M[i,0]*x + M[i,1]*y + M[i,2]*z for i in 0..2], left to right."""
    return [M[..., i, 0] * x + M[..., i, 1] * y + M[..., i, 2] * z
            for i in range(3)]


def _apply_rows(M: torch.Tensor, p: torch.Tensor) -> list:
    return _apply_rows_xyz(M, p[..., 0], p[..., 1], p[..., 2])


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    t_inv = -torch.stack(_apply_rows(Rt, t), dim=-1)
    top = torch.cat([Rt, t_inv[..., None]], dim=-1)
    return _append_bottom_row(top)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 T to points (...,3)."""
    rows = _apply_rows(T, points)
    return torch.stack([rows[i] + T[..., i, 3] for i in range(3)], dim=-1)


def transform_xyz(T: torch.Tensor, x, y, z) -> list:
    """Apply one 4x4 T to points given as three coordinate tensors that
    broadcast against each other (the axes of a grid, say): the three
    coordinates of ``transform_points`` on the broadcast points, value
    for value, without the [..., 3] tensor."""
    rows = _apply_rows_xyz(T, x, y, z)
    return [rows[i] + T[i, 3] for i in range(3)]


def rotate_vectors(T: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of T to direction vectors (...,3)."""
    return torch.stack(_apply_rows(T, vectors), dim=-1)
