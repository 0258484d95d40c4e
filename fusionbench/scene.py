"""The analytic scenes and trajectories the traffic is rendered from.

Frozen copy of ``topfusion_tpu_torch/io/synthetic.py`` at commit 81038a6
(``SyntheticScene``'s scenes, ``corridor_scene``, ``orbit_trajectory``,
``sweep_trajectory``), with the sphere tracer replaced by exact ray
casting of the same primitives, batched over frames, so that set-up
renders hundreds of VGA frames in a few calls on the card.  The sweep
takes seeded phases (0 gives the port's sweep).  Exact depth, no sensor
noise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .reference.geometry.se3 import se3_exp


@dataclasses.dataclass(frozen=True)
class Scene:
    """Union of spheres, axis-aligned boxes and planes (world metres);
    the default is the room of ``SyntheticScene()``."""

    spheres: Tuple[Tuple[float, ...], ...] = (
        (0.0, 0.1, 1.1, 0.25),      # (cx, cy, cz, r)
        (-0.35, -0.15, 0.9, 0.15),
    )
    boxes: Tuple[Tuple[float, ...], ...] = (
        (0.25, 0.05, 0.85, 0.12, 0.18, 0.12),  # (cx, cy, cz, hx, hy, hz)
    )
    # (nx, ny, nz, d): sdf = dot(n, p) + d, n unit, inside positive.
    planes: Tuple[Tuple[float, ...], ...] = (
        (0.0, 0.0, -1.0, 1.6),      # back wall at z = 1.6
        (0.0, -1.0, 0.0, 0.45),     # floor at y = 0.45 (y points down)
    )

    def first_hit(self, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Ray parameter of the first surface hit along ``o + t d``
        (``o`` [..., 3] broadcast against ``d`` [..., 3]), exact:
        planes and spheres in closed form, boxes by their slabs; +inf
        where no primitive is hit ahead."""
        dev = d.device
        inf = torch.full(d.shape[:-1], float("inf"), dtype=d.dtype, device=dev)
        t = inf
        for pl in self.planes:
            n = torch.tensor(pl[:3], dtype=d.dtype).to(dev)
            nd = torch.sum(d * n, dim=-1)
            s = -(torch.sum(o * n, dim=-1) + pl[3]) / torch.where(nd == 0, 1.0, nd)
            t = torch.minimum(t, torch.where((nd < 0) & (s > 0), s, inf))
        for sp in self.spheres:
            q = o - torch.tensor(sp[:3], dtype=d.dtype).to(dev)
            a = torch.sum(d * d, dim=-1)
            b = torch.sum(q * d, dim=-1)
            c = torch.sum(q * q, dim=-1) - sp[3] * sp[3]
            disc = b * b - a * c
            s = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
            t = torch.minimum(t, torch.where((disc >= 0) & (s > 0), s, inf))
        for bx in self.boxes:
            lo = torch.tensor([bx[0] - bx[3], bx[1] - bx[4], bx[2] - bx[5]], dtype=d.dtype).to(dev)
            hi = torch.tensor([bx[0] + bx[3], bx[1] + bx[4], bx[2] + bx[5]], dtype=d.dtype).to(dev)
            inv = 1.0 / torch.where(d == 0, 1e-30, d)
            t0, t1 = (lo - o) * inv, (hi - o) * inv
            near = torch.amax(torch.minimum(t0, t1), dim=-1)
            far = torch.amin(torch.maximum(t0, t1), dim=-1)
            t = torch.minimum(t, torch.where((near <= far) & (near > 0), near, inf))
        return t

    def render_depth_mm(self, cam: dict, poses: torch.Tensor, near: float = 0.05,
                        max_depth: float = 5.0, batch: int = 32) -> torch.Tensor:
        """u16 depth in millimetres [n, H, W] of camera-to-world ``poses``
        [n, 4, 4] (on the render device): exact ray casting of the
        scene, ``batch`` frames a call.  The rays have unit camera z, so
        the hit's parameter is its depth; a hit nearer than ``near`` or
        beyond ``max_depth`` reads 0, as no hit does."""
        h, w = cam["height"], cam["width"]
        dev = poses.device
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                              torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        dirs_cam = torch.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                                torch.ones_like(u)], dim=-1)
        out = []
        for i in range(0, poses.shape[0], batch):
            T = poses[i:i + batch]
            # dirs[b, y, x] = R_b @ dirs_cam[y, x], as three products.
            dirs = torch.sum(T[:, None, None, :3, :3] * dirs_cam[None, :, :, None, :], dim=-1)
            t = self.first_hit(T[:, None, None, :3, 3], dirs)
            hit = (t >= near) & (t < max_depth)
            d = torch.where(hit, t, 0.0)
            out.append(torch.round(d * 1000.0).to(torch.int32).to(torch.uint16))
        return torch.cat(out)


def corridor_scene(length_m: float = 12.0, box_every: float = 0.6) -> Scene:
    """A long corridor: side walls, floor, ceiling and a row of boxes
    marching down +z."""
    boxes = []
    z = 0.8
    k = 0
    while z < length_m:
        side = -0.45 if k % 2 == 0 else 0.45
        boxes.append((side, 0.25 - 0.15 * (k % 3), z, 0.12, 0.15, 0.12))
        z += box_every
        k += 1
    return Scene(
        spheres=(),
        boxes=tuple(boxes),
        planes=(
            (1.0, 0.0, 0.0, 0.8),     # left wall  x = -0.8
            (-1.0, 0.0, 0.0, 0.8),    # right wall x = +0.8
            (0.0, -1.0, 0.0, 0.45),   # floor      y = +0.45 (y down)
            (0.0, 1.0, 0.0, 0.8),     # ceiling    y = -0.8
        ),
    )


SCENES = {"room": Scene, "corridor": corridor_scene}


def _exp_poses(xis: np.ndarray) -> np.ndarray:
    return se3_exp(torch.from_numpy(np.asarray(xis, np.float32))).numpy()


def orbit_trajectory(n_frames: int, max_angle_deg: float, max_shift: float,
                     seed: int) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses: a smooth sinusoidal 6-DoF wander
    around identity that starts and ends there, phases and frequencies
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0.0, 2 * np.pi, size=6)
    freqs = rng.uniform(0.7, 1.3, size=6)
    xis = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        amp = np.sin(2 * np.pi * freqs * s + phases) * np.sin(np.pi * s)
        xis.append(np.concatenate([np.deg2rad(max_angle_deg) * amp[:3], max_shift * amp[3:]]))
    return _exp_poses(np.stack(xis))


def sweep_trajectory(n_frames: int, step_m: float, sway: float, seed: int) -> np.ndarray:
    """[n, 4, 4] poses of a forward dolly down +z, ``step_m`` a frame,
    with gentle lateral and angular sway whose four phases are drawn from
    ``seed``."""
    ph = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, size=4)
    xis = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        xis.append([
            0.03 * np.sin(4 * np.pi * s + ph[0]),
            0.05 * np.sin(2 * np.pi * s + ph[1]),
            0.0,
            sway * np.sin(6 * np.pi * s + ph[2]),
            0.5 * sway * np.cos(6 * np.pi * s + ph[3]),
            step_m * i,
        ])
    return _exp_poses(np.asarray(xis, np.float32))


TRAJECTORIES = {"orbit": orbit_trajectory, "sweep": sweep_trajectory}
