"""Reference-semantics parity A/B: exact mode against fast mode ATE (port
of ``scripts/parity_ab.py``).

The accuracy protocol of ``docs/RESULTS.md``: the bar is set by running
the reference *algorithm semantics* in this framework (exact mode =
``config.reference_exact_config``: positional bilateral / pyramid windows
with invalid neighbours, per-pixel "take" gathers + bilinear
association, level-0 stride 1, full-march raycast model maps, no
occlusion cull, the plain PyTorch integrate) and checking that the
production fast mode (flat row-gather ICP, nearest association, stride
2, splat model maps, the integrate kernel on the card through
``config.resolve_pallas_integrate``) tracks the same trajectory.

Runs the 90-frame VGA synthetic orbit at two sensor-noise levels and
prints a markdown table of ATEs, the fast/exact ratio and each mode's
frames/s (host clock around the steps, the poses fetched every frame).

Usage:  python3 -m topfusion_tpu_torch.tools.parity_ab [--frames 90] [--small] \\
            [--noise 0 1] [--device cpu | --cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run_mode(cfg, depths, gt, device):
    """Step ``depths`` (u16 tensors) through a fresh ``BlockPipeline``;
    returns (ATE in m, seconds, the last state)."""
    from ..io.trajectory import ate_rmse
    from ..models.block_pipeline import BlockPipeline
    from .timing import sync

    pipe = BlockPipeline(cfg, device)
    state = pipe.init()
    poses = []
    sync(device)
    t0 = time.perf_counter()
    for d in depths:
        state, aux = pipe.step(state, d)
        poses.append(state.T_wc.cpu().numpy())
        assert bool(aux.ok), "tracking lost"
    dt = time.perf_counter() - t0
    return ate_rmse(poses, [np.asarray(g) for g in gt], align=False), dt, state


def configs(small: bool):
    """(fast, exact) configurations of the A/B."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        PipelineConfig,
        RaycastConfig,
        reference_exact_config,
    )

    if small:
        cam = CameraConfig(width=160, height=120, fx=125.0, fy=125.0,
                           cx=80.0, cy=60.0)
    else:
        cam = CameraConfig(width=640, height=480, fx=500.0, fy=500.0,
                           cx=320.0, cy=240.0)
    fast_cfg = PipelineConfig(
        camera=cam,
        blockmap=BlockMapConfig(max_visible_blocks=4096),  # the kernel on the card
        raycast=RaycastConfig(max_steps=192),
    )
    return fast_cfg, reference_exact_config(fast_cfg)


def parity(frames: int, small: bool, noise, device) -> list:
    """The A/B over the orbit at each noise sigma (mm): one dict per
    level with both ATEs (m), their ratio, both modes' seconds, the last
    frame and the fast run's last state; prints a line per level."""
    import torch

    from ..io.synthetic import SyntheticScene, add_depth_noise, orbit_trajectory

    fast_cfg, exact_cfg = configs(small)
    cam = fast_cfg.camera
    scene = SyntheticScene()
    gt = orbit_trajectory(frames, max_angle_deg=5.0, max_shift=0.05,
                          seed=2)
    clean = [scene.render_depth_mm(cam, torch.as_tensor(T, dtype=torch.float32, device=device))
             .cpu().numpy() for T in gt]

    rows = []
    for sigma in noise:
        depths = [
            torch.from_numpy(add_depth_noise(d, sigma, seed=1000 + i)).to(device)
            for i, d in enumerate(clean)
        ]
        ate_exact, t_exact, _ = run_mode(exact_cfg, depths, gt, device)
        ate_fast, t_fast, fast_state = run_mode(fast_cfg, depths, gt, device)
        ratio = ate_fast / max(ate_exact, 1e-9)
        rows.append(dict(noise=sigma, exact=ate_exact, fast=ate_fast, ratio=ratio,
                         exact_s=t_exact, fast_s=t_fast, last_depth=depths[-1],
                         fast_state=fast_state))
        print(
            f"noise {sigma:.1f} mm: exact ATE {ate_exact*1000:.2f} mm "
            f"({frames/t_exact:.1f} fps), fast ATE "
            f"{ate_fast*1000:.2f} mm ({frames/t_fast:.1f} fps), "
            f"fast/exact = {ratio:.3f}",
            flush=True,
        )
    return rows


def print_table(rows, frames: int) -> None:
    print("\n| noise (mm) | exact ATE (mm) | fast ATE (mm) | fast/exact |"
          " exact fps | fast fps |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['noise']:.1f} | {r['exact']*1000:.4f} | {r['fast']*1000:.4f} | "
              f"{r['ratio']:.4f} | {frames/r['exact_s']:.2f} | {frames/r['fast_s']:.2f} |")


def main(argv=None) -> int:
    from ..utils.device_info import entry_device
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--small", action="store_true",
                    help="160x120 camera (fast CI-scale run)")
    ap.add_argument("--noise", type=float, nargs="*", default=[0.0, 1.0],
                    help="sensor noise sigmas in mm")
    add_device_arg(ap)
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="the JAX script's flag: --device cpu")
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    if device.type == "cuda":
        from ..utils.device_info import nvidia_smi_name_power

        print(nvidia_smi_name_power())
    print_table(parity(args.frames, args.small, args.noise, device), args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
