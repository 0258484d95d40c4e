"""The sharded step's per-step collective volume (port of
``scripts/measure_collectives.py``).

The weak-scaling argument (docs/SCALING.md) rests on the claim that the
sharded step's traffic between shards is IMAGE-sized (the composited
splat keys and attributes, ICP's Gram sums, the gathered allocation
candidates), whatever the map's size.  The JAX script sums the
collectives of the compiled HLO; here every shard is a process
(``parallel/block_sharded.ShardedBlockPipeline`` over
``parallel/collectives.MapAxis``) and the bytes it hands to the
collectives of one step are counted as they are issued (``MapAxis.calls``
/ ``.bytes``, by kind), on the second step of a static synthetic frame,
at the JAX script's device counts, image sizes and map capacities.

Usage:  python3 -m topfusion_tpu_torch.tools.measure_collectives [--devices 2 4 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

KINDS = {"_all_reduce": "all-reduce", "all_gather_tiled": "all-gather",
         "broadcast": "broadcast", "all_gather_object": "all-gather-object"}
IMAGES = ((80, 64), (160, 128), (320, 256))
CAPACITIES = (1 << 12, 1 << 14)


def collectives_config(w: int, h: int, capacity: int):
    """The JAX script's configuration at a w x h image and a capacity."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )

    cam = CameraConfig(width=w, height=h, fx=0.75 * w, fy=0.75 * w, cx=w / 2, cy=h / 2)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3),
        icp=ICPConfig(iters=(4, 3, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=capacity,
            max_new_blocks_per_frame=min(1024, capacity),
            max_visible_blocks=min(2048, capacity),
            alloc_pixel_stride=2,
        ),
        raycast=RaycastConfig(max_steps=64),
    )


def count_by_kind(axis) -> dict:
    """Wrap ``axis``' collectives so that each adds its bytes to the
    returned dict under its kind."""
    by_kind = dict.fromkeys(KINDS.values(), 0)

    def wrap(attr, kind):
        fn = getattr(axis, attr)

        def call(*a, **kw):
            before = axis.bytes
            out = fn(*a, **kw)
            by_kind[kind] += axis.bytes - before
            return out
        setattr(axis, attr, call)

    for attr, kind in KINDS.items():
        wrap(attr, kind)
    return by_kind


def measure_body(axis, grid) -> list:
    """One shard of a world: for each (w, h, capacity) of ``grid``, two
    steps of the scene at identity; the second step's collectives."""
    import torch

    from ..io.synthetic import SyntheticScene
    from ..parallel.block_sharded import ShardedBlockPipeline

    by_kind = count_by_kind(axis)
    rows = []
    for w, h, capacity in grid:
        cfg = collectives_config(w, h, capacity)
        pipe = ShardedBlockPipeline(cfg, axis, axis.device)
        depth = SyntheticScene().render_depth_mm(cfg.camera, torch.eye(4, device=axis.device))
        state, _ = pipe.step(pipe.init(), depth)
        calls0, bytes0 = axis.calls, axis.bytes
        kinds0 = dict(by_kind)
        state, aux = pipe.step(state, depth)
        rows.append({
            "devices": axis.size, "image": f"{w}x{h}", "pixels": w * h, "capacity": capacity,
            "calls": axis.calls - calls0, "total_bytes": axis.bytes - bytes0,
            **{k: by_kind[k] - kinds0[k] for k in by_kind if by_kind[k] - kinds0[k]},
            "ok": bool(aux.ok),
        })
    return rows


def main(argv=None) -> int:
    import torch

    from ..parallel.launch import spawn_world
    from ..utils.device_info import entry_device
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, nargs="+", default=[2, 4, 8])
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    rows = []
    # Image scaling at fixed capacity (weak scaling: image grows with
    # the workload) and capacity scaling at fixed image (the claim:
    # collectives do NOT grow with the map).
    for i, nd in enumerate(args.devices):
        grid = [(w, h, CAPACITIES[0]) for w, h in IMAGES]
        if i == 0:
            grid.append((160, 128, CAPACITIES[1]))
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        backend = "nccl" if device.type == "cuda" and cards >= nd else "gloo"
        got = spawn_world(measure_body, nd, backend, str(device), args=(grid,))
        for r in got[0]:
            r["backend"] = backend
            print(json.dumps(r), flush=True)
        rows += got[0]

    print(f"{'dev':>4} {'image':>9} {'capacity':>9} {'calls':>6} {'coll. KB/step':>14}")
    for r in rows:
        print(f"{r['devices']:>4} {r['image']:>9} {r['capacity']:>9} {r['calls']:>6} "
              f"{r['total_bytes']/1024:>14.1f}")
    # The claims:
    base = [r for r in rows if r["devices"] == args.devices[0]
            and r["capacity"] == CAPACITIES[0]]
    big = [r for r in rows if r["capacity"] == CAPACITIES[1]][0]
    small = [r for r in base if r["image"] == "160x128"][0]
    growth = (base[-1]["total_bytes"] / base[0]["total_bytes"]) / (
        base[-1]["pixels"] / base[0]["pixels"]
    )
    cap_growth = big["total_bytes"] / small["total_bytes"]
    print(f"\nimage-scaling exponent vs area: {growth:.2f} "
          f"(1.0 = proportional)")
    print(f"capacity x4 -> collective volume x{cap_growth:.2f} "
          f"(claim: ~1.0, map-independent)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
