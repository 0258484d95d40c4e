"""TUM-format trajectory files and trajectory accuracy (ATE) in numpy,
copied from ``topfusion_tpu/io/trajectory.py`` because importing that
package loads jax.  A line of a TUM trajectory is ``t tx ty tz qx qy qz
qw`` (camera-to-world)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion [qx, qy, qz, qw]."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.empty(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    qx, qy, qz, qw = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def save_tum_trajectory(
    path: str, poses: Sequence[np.ndarray], timestamps: Sequence[float] | None = None
) -> None:
    """Write camera-to-world poses in TUM format."""
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            T = np.asarray(T)
            ts = timestamps[i] if timestamps is not None else float(i)
            q = _rot_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Read TUM-format trajectory -> (timestamps, 4x4 poses)."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            stamps.append(vals[0])
            T = np.eye(4)
            T[:3, 3] = vals[1:4]
            T[:3, :3] = _quat_to_rot(np.asarray(vals[4:8]))
            poses.append(T)
    return np.asarray(stamps), poses


def align_umeyama(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares SE(3)/Sim(3) alignment est -> gt over [N, 3] points.

    Returns (R, t, s) minimizing ||gt - (s R est + t)||^2.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec**2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    align: bool = True,
) -> float:
    """Absolute trajectory error RMSE (meters) over translations."""
    est = np.asarray([np.asarray(T)[:3, 3] for T in est_poses])
    gt = np.asarray([np.asarray(T)[:3, 3] for T in gt_poses])
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")
    if align and len(est) >= 3:
        R, t, s = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))
