"""Synthetic depth and RGB sequences from analytic SDF scenes (port of
``topfusion_tpu/io/synthetic.py``): exact ground-truth trajectories and
registered flat-albedo color frames without any dataset on disk.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..geometry.camera import pixel_grid
from ..geometry.se3 import se3_exp
from ..utils.device_info import entry_device
from ..utils.numerics import true_div


_PALETTE = (
    (0.9, 0.2, 0.2),
    (0.2, 0.8, 0.3),
    (0.25, 0.35, 0.9),
    (0.9, 0.8, 0.2),
    (0.8, 0.3, 0.8),
    (0.3, 0.8, 0.8),
    (0.9, 0.55, 0.2),
    (0.6, 0.6, 0.6),
)


@dataclasses.dataclass(frozen=True)
class SyntheticScene:
    """Analytic SDF scene: union of spheres, axis-aligned boxes and planes
    (world meters).  The default is the JAX package's room: back wall,
    floor, two spheres and a box in front of the origin."""

    spheres: Tuple[Tuple[float, float, float, float], ...] = (
        (0.0, 0.1, 1.1, 0.25),      # (cx, cy, cz, r)
        (-0.35, -0.15, 0.9, 0.15),
    )
    boxes: Tuple[Tuple[float, float, float, float, float, float], ...] = (
        (0.25, 0.05, 0.85, 0.12, 0.18, 0.12),  # (cx, cy, cz, hx, hy, hz)
    )
    # Planes as (nx, ny, nz, d): sdf = dot(n, p) + d, n unit, inside positive.
    planes: Tuple[Tuple[float, float, float, float], ...] = (
        (0.0, 0.0, -1.0, 1.6),      # back wall at z = 1.6
        (0.0, -1.0, 0.0, 0.45),     # floor at y = 0.45 (y points down)
    )

    def primitives(self, device=None, dtype=torch.float32):
        """The scene's primitives as tensors on ``device`` (built once per
        render, so the sphere-tracing loop does no host copies)."""
        def vecs(rows, width):
            return torch.tensor(rows, dtype=dtype).reshape(-1, width).to(device)

        return (vecs(self.spheres, 4), vecs(self.boxes, 6), vecs(self.planes, 4))

    def _distances(self, p: torch.Tensor, prims=None) -> List[torch.Tensor]:
        """Signed distance from world points p (..., 3) to each primitive,
        in the order spheres, boxes, planes."""
        spheres, boxes, planes = prims or self.primitives(p.device, p.dtype)
        dists = []
        for s in spheres:
            dists.append(torch.linalg.vector_norm(p - s[:3], dim=-1) - s[3])
        for b in boxes:
            q = torch.abs(p - b[:3]) - b[3:]
            outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
            inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
            dists.append(outside + inside)
        for pl in planes:
            dists.append(torch.sum(p * pl[:3], dim=-1) + pl[3])
        return dists

    def sdf(self, p: torch.Tensor, prims=None) -> torch.Tensor:
        """Exact signed distance at world points p (..., 3)."""
        d = torch.full(p.shape[:-1], float("inf"), dtype=p.dtype, device=p.device)
        for dist in self._distances(p, prims):
            d = torch.minimum(d, dist)
        return d

    @staticmethod
    def _rays(cam: CameraConfig, T_wc: torch.Tensor):
        """(origin [3], world directions [H, W, 3] with unit camera z)."""
        uv = pixel_grid(cam, device=T_wc.device)
        dirs_cam = torch.stack(
            [
                true_div(uv[..., 0] - cam.cx, cam.fx),
                true_div(uv[..., 1] - cam.cy, cam.fy),
                torch.ones_like(uv[..., 0]),
            ],
            dim=-1,
        )
        return T_wc[:3, 3], dirs_cam @ T_wc[:3, :3].T

    def render_depth(
        self,
        cam: CameraConfig,
        T_wc: torch.Tensor,
        max_depth: float = 5.0,
        n_steps: int = 128,
    ) -> torch.Tensor:
        """Sphere-trace exact depth [H, W] in meters (0 = no hit)."""
        o, dirs_w = self._rays(cam, T_wc)
        dir_norm = torch.linalg.vector_norm(dirs_w, dim=-1)

        prims = self.primitives(T_wc.device)
        t = torch.full(dirs_w.shape[:2], 0.05, dtype=torch.float32, device=T_wc.device)
        for _ in range(n_steps):
            t = t + self.sdf(o + t[..., None] * dirs_w, prims) / dir_norm
        d_hit = self.sdf(o + t[..., None] * dirs_w, prims)
        hit = (torch.abs(d_hit) < 1e-3) & (t > 0.0) & (t < max_depth)
        return torch.where(hit, t, 0.0)

    def render_depth_mm(self, cam, T_wc, **kw) -> torch.Tensor:
        """Depth as u16 millimeters (the sensor format)."""
        d = self.render_depth(cam, T_wc, **kw)
        return torch.round(d * 1000.0).to(torch.int32).to(torch.uint16)

    # ------------------------------------------------------------- color
    def primitive_colors(self, device=None) -> torch.Tensor:
        """One palette RGB (in [0, 1]) per primitive, in sdf() order
        (spheres, boxes, planes)."""
        n = len(self.spheres) + len(self.boxes) + len(self.planes)
        return torch.tensor(
            [_PALETTE[i % len(_PALETTE)] for i in range(n)], dtype=torch.float32
        ).to(device)

    def color_at(self, p: torch.Tensor) -> torch.Tensor:
        """Albedo at world points p (..., 3): the palette color of the
        nearest primitive (flat shading, so the fused color volume can
        recover it exactly)."""
        which = torch.argmin(torch.stack(self._distances(p), dim=-1), dim=-1)
        return self.primitive_colors(p.device)[which]

    def render_rgb(self, cam: CameraConfig, T_wc: torch.Tensor, **kw) -> torch.Tensor:
        """Flat-albedo RGB image [H, W, 3] uint8 registered to the depth
        image (black where depth is invalid): the synthetic stand-in for
        a sensor's registered RGB stream."""
        d = self.render_depth(cam, T_wc, **kw)
        o, dirs_w = self._rays(cam, T_wc)
        rgb = torch.where(d[..., None] > 0.0, self.color_at(o + d[..., None] * dirs_w), 0.0)
        return torch.round(rgb * 255.0).to(torch.uint8)


def corridor_scene(length_m: float = 12.0, box_every: float = 0.6) -> SyntheticScene:
    """A long corridor: side walls + floor + ceiling planes and a row of
    boxes marching down +z (allocation-stress scenario)."""
    boxes = []
    z = 0.8
    k = 0
    while z < length_m:
        side = -0.45 if k % 2 == 0 else 0.45
        boxes.append((side, 0.25 - 0.15 * (k % 3), z, 0.12, 0.15, 0.12))
        z += box_every
        k += 1
    return SyntheticScene(
        spheres=(),
        boxes=tuple(boxes),
        planes=(
            (1.0, 0.0, 0.0, 0.8),     # left wall  x = -0.8
            (-1.0, 0.0, 0.0, 0.8),    # right wall x = +0.8
            (0.0, -1.0, 0.0, 0.45),   # floor      y = +0.45 (y down)
            (0.0, 1.0, 0.0, 0.8),     # ceiling    y = -0.8
        ),
    )


def _exp_pose(xi: np.ndarray) -> np.ndarray:
    return se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()


def sweep_trajectory(
    n_frames: int, step_m: float = 0.03, sway: float = 0.04
) -> List[np.ndarray]:
    """Forward dolly down the corridor with gentle lateral/angular sway."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        xi = np.array(
            [
                0.03 * np.sin(4 * np.pi * s),
                0.05 * np.sin(2 * np.pi * s),
                0.0,
                sway * np.sin(6 * np.pi * s),
                0.5 * sway * np.cos(6 * np.pi * s),
                step_m * i,
            ],
            np.float32,
        )
        poses.append(_exp_pose(xi))
    return poses


def add_depth_noise(
    depth_mm: np.ndarray, sigma_mm: float, seed: int = 0
) -> np.ndarray:
    """Additive Gaussian sensor noise (sigma in millimeters) on a u16
    depth image; invalid (0) pixels stay invalid."""
    if sigma_mm <= 0.0:
        return depth_mm
    rng = np.random.default_rng(seed)
    d = depth_mm.astype(np.float32)
    noisy = d + rng.normal(0.0, sigma_mm, size=d.shape).astype(np.float32)
    noisy = np.where(d > 0, np.clip(np.round(noisy), 1, 65535), 0)
    return noisy.astype(np.uint16)


def orbit_trajectory(
    n_frames: int,
    max_angle_deg: float = 8.0,
    max_shift: float = 0.08,
    seed: int = 0,
    smooth: bool = True,
) -> List[np.ndarray]:
    """Ground-truth camera-to-world poses: smooth sinusoidal 6-DoF wander
    around identity (keeps the default scene in view)."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0.0, 2 * np.pi, size=6)
    freqs = rng.uniform(0.7, 1.3, size=6)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        amp = np.sin(2 * np.pi * freqs * s + phases) * np.sin(np.pi * s) \
            if smooth else np.sin(2 * np.pi * freqs * s + phases)
        ang = np.deg2rad(max_angle_deg) * amp[:3]
        shift = max_shift * amp[3:]
        poses.append(_exp_pose(np.concatenate([ang, shift])))
    return poses


def make_sequence(
    cam: CameraConfig,
    n_frames: int,
    scene: SyntheticScene | None = None,
    seed: int = 0,
    device="cuda",
    **orbit_kw,
) -> Tuple[List[np.ndarray], List[np.ndarray], SyntheticScene]:
    """(u16 depth frames as numpy, ground-truth poses, scene) of an
    ``orbit_trajectory``, rendered on ``device`` (the card unless the
    caller names another)."""
    dev = entry_device(device)
    scene = scene or SyntheticScene()
    poses = orbit_trajectory(n_frames, seed=seed, **orbit_kw)
    depths = [
        scene.render_depth_mm(cam, torch.as_tensor(T, dtype=torch.float32, device=dev)).cpu().numpy()
        for T in poses
    ]
    return depths, poses, scene
