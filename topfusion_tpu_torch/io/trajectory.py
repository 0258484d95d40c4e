"""Trajectory accuracy (ATE) in numpy, copied from
``topfusion_tpu/io/trajectory.py`` because importing that package loads
jax."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


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
