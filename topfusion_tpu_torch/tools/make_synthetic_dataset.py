"""Write a TUM-RGB-D-format dataset directory from the analytic scene
(port of ``scripts/make_synthetic_dataset.py``).

16-bit depth PNGs at 5000 units/m (written by ``io/png.py``), depth.txt,
camera.txt and groundtruth.txt with quaternion poses, from the analytic
SDF scene rendered on the card, with an optional Kinect-style depth
noise model (quadratic-in-z Gaussian noise, quantization, edge dropout)
drawn on the host from ``numpy.random.default_rng(--seed)`` in the JAX
script's order, so that the app's ``--sequence`` path and
``io/datasets.TUMSequence`` run as they would on real data.

``--format icl`` writes the ICL-NUIM flavor: the TUM-compatible ICL
layout with the ICL camera convention, NEGATIVE fy (y axis flipped,
``io/datasets.ICL_CAMERA``).

Usage:
  python3 -m topfusion_tpu_torch.tools.make_synthetic_dataset --out /tmp/tum_synth \\
      --frames 60 --noise 1.0 [--vga] [--format icl] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def kinect_noise(depth_m: np.ndarray, rng: np.random.Generator,
                 scale: float = 1.0) -> np.ndarray:
    """Kinect-class axial noise: sigma(z) ~= 1.2 mm + 1.9 mm * (z-0.4)^2
    (Khoshelham & Elberink 2012 magnitudes), plus 1-2% random edge dropout."""
    z = depth_m
    valid = z > 0
    sigma = (0.0012 + 0.0019 * np.square(np.maximum(z - 0.4, 0.0))) * scale
    noisy = z + rng.normal(0.0, 1.0, z.shape) * sigma
    drop = rng.random(z.shape) < 0.015 * scale
    return np.where(valid & ~drop, np.maximum(noisy, 0.0), 0.0)


def main(argv=None) -> int:
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--noise", type=float, default=1.0,
                    help="noise scale (0 = perfect depth)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--vga", action="store_true",
                    help="640x480 TUM fr1 intrinsics (default 320x240)")
    ap.add_argument("--angle", type=float, default=8.0)
    ap.add_argument("--shift", type=float, default=0.10)
    ap.add_argument("--format", choices=("tum", "icl"), default="tum",
                    help="dataset flavor: tum (fr1 intrinsics) or icl "
                    "(ICL-NUIM convention, NEGATIVE fy)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ..config import CameraConfig
    from ..io.datasets import ICL_CAMERA, TUM_DEPTH_SCALE, TUM_FR1_CAMERA
    from ..io.png import write_png
    from ..io.synthetic import SyntheticScene, orbit_trajectory
    from ..io.trajectory import save_tum_trajectory
    from ..utils.device_info import entry_device

    device = entry_device(args.device)
    if args.format == "icl":
        cam = ICL_CAMERA if args.vga else CameraConfig(
            width=320, height=240, fx=240.6, fy=-240.0, cx=159.75,
            cy=119.75,  # ICL-NUIM halved, fy NEGATIVE (its convention)
        )
    elif args.vga:
        cam = TUM_FR1_CAMERA
    else:
        cam = CameraConfig(width=320, height=240, fx=258.65, fy=258.25,
                           cx=159.3, cy=127.65)  # TUM fr1 halved

    os.makedirs(os.path.join(args.out, "depth"), exist_ok=True)
    scene = SyntheticScene()
    poses = orbit_trajectory(
        args.frames, max_angle_deg=args.angle, max_shift=args.shift,
        seed=args.seed,
    )
    rng = np.random.default_rng(args.seed)

    lines = []
    stamps = []
    for i, T in enumerate(poses):
        ts = i / 30.0
        T_d = torch.as_tensor(T, dtype=torch.float32, device=device)
        d = scene.render_depth(cam, T_d).cpu().numpy()
        if args.noise > 0:
            d = kinect_noise(d, rng, args.noise)
        png = np.clip(np.round(d * TUM_DEPTH_SCALE), 0, 65535).astype(
            np.uint16
        )
        rel = f"depth/{ts:.6f}.png"
        write_png(os.path.join(args.out, rel), png)
        lines.append(f"{ts:.6f} {rel}")
        stamps.append(ts)

    with open(os.path.join(args.out, "depth.txt"), "w") as f:
        f.write("# timestamp filename\n")
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(args.out, "camera.txt"), "w") as f:
        f.write(f"{cam.width} {cam.height} {cam.fx} {cam.fy} "
                f"{cam.cx} {cam.cy}\n")
    save_tum_trajectory(
        os.path.join(args.out, "groundtruth.txt"),
        [np.asarray(T) for T in poses],
        timestamps=stamps,
    )
    print(f"wrote {len(poses)} frames to {args.out} "
          f"({cam.width}x{cam.height}, noise={args.noise})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
