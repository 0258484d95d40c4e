"""Free-view camera paths over a reconstructed map (the port's copy of
``topfusion_tpu/geometry/viewpath.py``; numpy only, like the original,
and kept here because the port imports nothing of the JAX package).

The map is replayed offline from arbitrary poses through the ranged
free-view raycast (``models/block_pipeline.BlockPipeline.render``): this
module builds those poses: look-at matrices, auto-orbits around the
reconstructed geometry, and incremental key-driven moves.

Convention: poses are T_wc (world-from-camera), camera x right / y down /
z forward.
"""

from __future__ import annotations

from typing import List

import numpy as np


def look_at(
    eye: np.ndarray, target: np.ndarray, up_hint: np.ndarray
) -> np.ndarray:
    """T_wc whose +z axis points from ``eye`` at ``target``.

    ``up_hint`` is the world direction that should map to the camera's
    -y (image up); it only needs to be non-parallel to the view ray.
    """
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z = z / max(np.linalg.norm(z), 1e-12)
    down = -np.asarray(up_hint, np.float64)  # camera y is image DOWN
    x = np.cross(down, z)
    n = np.linalg.norm(x)
    if n < 1e-6:  # view ray parallel to up: pick any perpendicular
        x = np.cross(np.asarray([1.0, 0.0, 0.0]), z)
        n = np.linalg.norm(x)
    x = x / n
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def map_centroid(block_coords: np.ndarray, num_blocks: int,
                 block_metric: float) -> np.ndarray:
    """Center of mass of the allocated blocks (world meters)."""
    n = max(int(num_blocks), 1)
    c = np.asarray(block_coords[:n], np.float64)
    return ((c + 0.5) * block_metric).mean(axis=0).astype(np.float32)


def orbit_path(
    center: np.ndarray,
    anchor_T_wc: np.ndarray,
    n: int,
    max_sweep_deg: float = 360.0,
) -> List[np.ndarray]:
    """``n`` poses orbiting ``center`` starting AT the anchor camera.

    The orbit lives in the plane through the anchor eye perpendicular to
    the anchor camera's image-up, so the flythrough leaves the observed
    surface in view the whole way around (a full-circle orbit of a
    one-sided reconstruction still shows the empty backside honestly —
    free-view means free).
    """
    anchor = np.asarray(anchor_T_wc, np.float64)
    center = np.asarray(center, np.float64)
    eye0 = anchor[:3, 3]
    up = -anchor[:3, 1]  # camera -y = image up
    up = up / max(np.linalg.norm(up), 1e-12)
    r_vec = eye0 - center
    # Orbit in the plane perpendicular to up through the anchor eye.
    r_in = r_vec - up * np.dot(r_vec, up)
    radius = np.linalg.norm(r_in)
    if radius < 1e-6:
        r_in = anchor[:3, 2] * -1.0
        radius = 1.0
    a = r_in / radius
    b = np.cross(up, a)
    out = []
    for k in range(n):
        th = np.radians(max_sweep_deg) * k / max(n, 1)
        eye = center + (a * np.cos(th) + b * np.sin(th)) * radius \
            + up * np.dot(r_vec, up)
        out.append(look_at(eye, center, up))
    return out


def move_pose(
    T_wc: np.ndarray,
    key: str,
    step_m: float = 0.1,
    step_deg: float = 10.0,
) -> np.ndarray:
    """Apply one keyboard move to a pose.

    w/s: forward/back along view; a/d: strafe; r/f: up/down;
    j/l: yaw left/right; i/k: pitch up/down.
    """
    T = np.asarray(T_wc, np.float64).copy()
    R, t = T[:3, :3], T[:3, 3]
    th = np.radians(step_deg)
    c, s = np.cos(th), np.sin(th)
    if key == "w":
        t += R[:, 2] * step_m
    elif key == "s":
        t -= R[:, 2] * step_m
    elif key == "a":
        t -= R[:, 0] * step_m
    elif key == "d":
        t += R[:, 0] * step_m
    elif key == "r":
        t -= R[:, 1] * step_m   # camera y is down
    elif key == "f":
        t += R[:, 1] * step_m
    elif key == "j":
        rot = np.asarray([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        T[:3, :3] = R @ rot
    elif key == "l":
        rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, :3] = R @ rot
    elif key == "i":
        rot = np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])
        T[:3, :3] = R @ rot
    elif key == "k":
        rot = np.asarray([[1, 0, 0], [0, c, s], [0, -s, c]])
        T[:3, :3] = R @ rot
    T[:3, 3] = t
    return T.astype(np.float32)
