"""Free-view map viewer (port of ``scripts/view.py``): step a saved
reconstruction with keyboard moves and re-render it through the ranged
free-view raycast.

Loads a run directory written by the port's app
(``python3 -m topfusion_tpu_torch.apps.run_fusion``): ``config.yaml``, or
``config.json`` where pyyaml is missing, and ``state.npz``.  Each move
re-renders the map from the new pose and writes ``view.png`` in the run
directory (watch it with any auto-reloading image viewer).

Keys: w/s forward/back, a/d strafe, r/f up/down, j/l yaw, i/k pitch,
o = jump to an orbit vantage of the map centroid, p = print pose,
q = quit.  Non-interactive: ``--script wwjjq`` replays a key string.

Usage:
  python3 -m topfusion_tpu_torch.tools.view /tmp/run
  python3 -m topfusion_tpu_torch.tools.view /tmp/run --script "wwjjsskk" --step 0.05
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run_config_path(run_dir: str) -> str:
    """The run's configuration file: config.yaml, else config.json."""
    for name in ("config.yaml", "config.json"):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no config.yaml or config.json in {run_dir}")


def main(argv=None) -> int:
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir", help="output directory of apps/run_fusion.py")
    ap.add_argument("--script", default=None,
                    help="key string to replay non-interactively")
    ap.add_argument("--step", type=float, default=0.1, help="move step (m)")
    ap.add_argument("--deg", type=float, default=10.0, help="turn step (deg)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from ..geometry.viewpath import map_centroid, move_pose, orbit_path
    from ..io.png import write_png
    from ..models.block_pipeline import BlockPipeline
    from ..utils.checkpoint import load_state
    from ..utils.config_io import load_config
    from ..utils.device_info import entry_device

    device = entry_device(args.device)
    cfg = load_config(run_config_path(args.run_dir))
    pipe = BlockPipeline(cfg, device)
    state = load_state(os.path.join(args.run_dir, "state.npz"), pipe.init())
    T = state.T_wc.cpu().numpy()
    bm = cfg.blockmap.block_size * cfg.tsdf.voxel_size
    center = map_centroid(state.block_coords.cpu().numpy(), int(state.num_blocks), bm)
    out_png = os.path.join(args.run_dir, "view.png")

    def render(T_np):
        t0 = time.perf_counter()
        img = pipe.render(state, torch.as_tensor(T_np, dtype=torch.float32, device=device))
        img = img.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000
        write_png(out_png, img)
        cov = img.any(axis=-1).mean()
        print(
            f"pose t=({T_np[0,3]:+.2f},{T_np[1,3]:+.2f},{T_np[2,3]:+.2f})  "
            f"coverage {cov:.0%}  -> {out_png}  ({ms:.1f} ms render)"
        )

    print(f"map: {int(state.num_blocks)} blocks, centroid {np.round(center, 2)}")
    render(T)

    def keys():
        if args.script is not None:
            yield from args.script
            return
        print("keys: w/s a/d r/f j/l i/k move, o orbit view, p pose, q quit")
        while True:
            try:
                line = input("> ")
            except EOFError:
                return
            if not line:
                continue
            yield from line.strip()

    for k in keys():
        if k == "q":
            break
        if k == "p":
            print(T)
            continue
        if k == "o":
            T = orbit_path(center, T, 8)[1]
        else:
            T = move_pose(T, k, step_m=args.step, step_deg=args.deg)
        render(T)
    print(f"final pose {np.asarray(T, np.float64).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
