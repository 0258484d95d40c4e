"""Per-stage timing of the block pipeline's step (port of
``scripts/profile_stages.py``).

The bench configuration (``tools/bench_config.py``) on the state after 2
frames of the 4-frame orbit; every stage of ``BlockPipeline.step`` on
frame 2, in the step's order and with the step's arguments (the splat's
surfels per block and dilation, the occlusion cull's depth): depth
preprocessing, the vertex / normal pyramid, ICP, allocation, the visible
set, the integrate as plain PyTorch and through the CUDA kernel, the
splat, the guided and the full raycast, one level of the model pyramid,
and the full step.  Each row: latency (a sync after each call),
pipelined (n calls queued, one sync), device ms and device operations
of one profiled call (``tools/timing.py``).  Then the stages that make a
step summed against the full step, and the full step's five costliest
kernels with the stages that launch them.  On the card it first checks
the profiler against a count known in advance (``timing.profiler_check``).

The integrate rows fuse into a copy of the map (the kernel writes its
pool in place), so every later row sees the map the JAX script's does.

Usage:  python3 -m topfusion_tpu_torch.tools.profile_stages [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import sys
import types


def prepare(cfg, device):
    """The state after 2 frames of the orbit and every stage's inputs on
    frame 2, as a namespace."""
    import torch

    from ..io.synthetic import SyntheticScene, orbit_trajectory
    from ..models.block_pipeline import BlockPipeline
    from ..ops.depth import preprocess_depth
    from ..ops.normals import build_maps_pyramid
    from ..ops.tsdf_block import visible_blocks
    from .timing import sync

    cam = cfg.camera
    scene = SyntheticScene()
    poses = orbit_trajectory(4, max_angle_deg=3.0, max_shift=0.03, seed=1)
    frames = [scene.render_depth_mm(cam, torch.as_tensor(T, dtype=torch.float32, device=device))
              for T in poses]
    pipe = BlockPipeline(cfg, device)
    state = pipe.init()
    state, _ = pipe.step(state, frames[0])
    state, _ = pipe.step(state, frames[1])
    m = state.block_map()
    T = state.T_wc
    depth_mm = frames[2]
    raw_m, pyr = preprocess_depth(depth_mm, cfg.preproc)
    cur_pts, cur_nrm = build_maps_pyramid(cam, pyr)
    d_cull = raw_m if cfg.blockmap.visible_occlusion_cull else None
    vis = visible_blocks(m, cam, cfg.tsdf, cfg.blockmap, T, depth=d_cull)
    sync(device)
    return types.SimpleNamespace(cfg=cfg, pipe=pipe, state=state, m=m, T=T, depth_mm=depth_mm,
                                 raw_m=raw_m, pyr=pyr, cur_pts=cur_pts, cur_nrm=cur_nrm,
                                 d_cull=d_cull, vis=vis)


def copy_map(m):
    """``m`` with its pools copied (the kernel fuses in place)."""
    return m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone())


def stages(x) -> list:
    """(row name, fn, args, counts toward the step) in the step's order."""
    from ..ops.cuda.integrate import integrate_blocks_cuda
    from ..ops.depth import preprocess_depth
    from ..ops.icp import icp_track
    from ..ops.normals import build_maps_pyramid, resize_points_normals
    from ..ops.splat import splat_model_maps
    from ..ops.tsdf_block import (
        allocate_from_depth,
        integrate_blocks,
        raycast_blocks,
        visible_blocks,
    )

    cfg = x.cfg
    cam, tc, bm, rc = cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast
    margin = cfg.icp.dist_threshold + 3.0 * tc.trunc_dist
    m_plain, m_kernel = copy_map(x.m), copy_map(x.m)
    guided = raycast_blocks(x.m, cam, tc, bm, rc, x.T, expected_depth=x.raw_m,
                            depth_margin=margin, max_steps=rc.guided_max_steps)
    iters = ",".join(str(i) for i in cfg.icp.iters)
    levels = cfg.preproc.pyramid_levels - 1  # resize calls per step
    return [
        ("preprocess_depth", lambda d: preprocess_depth(d, cfg.preproc), (x.depth_mm,), 1),
        ("build_maps_pyramid", lambda p: build_maps_pyramid(cam, p), (x.pyr,), 1),
        (f"icp_track({iters})", lambda T, cp, cn, mp, mn: icp_track(
            cam, cfg.icp, T, T, cp, cn, list(mp), list(mn)),
         (x.T, x.cur_pts, x.cur_nrm, x.state.model_points, x.state.model_normals), 1),
        ("allocate_from_depth", lambda m, T, d: allocate_from_depth(
            m, cam, tc, bm, T, d, return_touched=True), (x.m, x.T, x.raw_m), 1),
        ("visible_blocks", lambda m, T: visible_blocks(
            m, cam, tc, bm, T, return_overflow=True, depth=x.d_cull), (x.m, x.T), 1),
        ("integrate_blocks(plain)", lambda m, T, d, v: integrate_blocks(
            m, cam, tc, bm, T, d, v), (m_plain, x.T, x.raw_m, x.vis), 0),
        ("integrate_blocks(cuda)", lambda m, T, d, v: integrate_blocks_cuda(
            m, cam, tc, bm, T, d, v), (m_kernel, x.T, x.raw_m, x.vis), 1),
        ("splat_model_maps", lambda m, T, v: splat_model_maps(
            m, cam, tc, bm, T, v, surfels_per_block=rc.surfels_per_block,
            dilate_passes=rc.dilate_passes), (x.m, x.T, x.vis), 1),
        ("raycast guided", lambda m, T, d: raycast_blocks(
            m, cam, tc, bm, rc, T, expected_depth=d, depth_margin=margin,
            max_steps=rc.guided_max_steps), (x.m, x.T, x.raw_m), 0),
        ("raycast full", lambda m, T: raycast_blocks(m, cam, tc, bm, rc, T), (x.m, x.T), 0),
        ("resize_points_normals", resize_points_normals, (guided.points, guided.normals), levels),
        ("FULL step", x.pipe.step, (x.state, x.depth_mm), 0),
    ]


def summary(timer, weights) -> None:
    """The stages that make a step, summed, against the full step; and
    the full step's five costliest kernels by the stages that launch
    them (device time per call)."""
    rows = timer.rows
    full = rows[-1]
    parts = [(r, w) for r, w in zip(rows, weights) if w]

    def total(key):
        vals = [r[key] for r, _ in parts]
        return None if None in vals else sum(v * w for v, (_, w) in zip(vals, parts))

    step = dict(name="sum of the step's stages", lat_ms=total("lat_ms"),
                pipelined_ms=total("pipelined_ms"), device_ms=total("device_ms"),
                ops=total("ops"))
    print(timer.format(step))
    ratio = [f"{k} {step[k] / full[k]:.3f}" for k in ("lat_ms", "pipelined_ms", "device_ms", "ops")
             if step[k] is not None and full[k]]
    print(f"{'sum / FULL step':{timer.width}s}   " + ", ".join(ratio), flush=True)
    if not full["kernels"]:
        return
    print("FULL step's five costliest kernels (device ms per step) and the stages that launch them:")
    for name, us in full["kernels"].most_common(5):
        by = collections.Counter()
        for r, w in parts:
            if r["kernels"].get(name):
                by[r["name"]] += r["kernels"][name] * w / 1000
        where = ", ".join(f"{s} {ms:.3f}" for s, ms in by.most_common()) or "none of the rows"
        print(f"  {us / 1000:8.3f}  {name[:90]}\n            {where}")


def run(cfg, device, n: int = 10):
    """Every stage's row and the summary; returns (the inputs, the Timer)."""
    import torch

    from .timing import PAD, Timer, profiler_check

    if torch.device(device).type == "cuda":
        c = profiler_check(device)
        print(f"# profiler check, 100 one-kernel calls a session: recorded {c['padded']} with the "
              f"pads (pad kernels kept {c['pads']} of {2 * PAD}), {c['bare']} without", flush=True)
    x = prepare(cfg, device)
    timer = Timer(device, n=n)
    print(timer.header())
    table = stages(x)
    for name, fn, fn_args, _ in table:
        timer.row(name, fn, *fn_args)
    summary(timer, [w for *_, w in table])
    return x, timer


def main(argv=None) -> int:
    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .bench_config import bench_config
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    if device.type == "cuda":
        print(nvidia_smi_name_power())
    run(bench_config(), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
