"""Offline reconstruction app of the PyTorch/CUDA port: a sequence in,
trajectories, map, cloud and renders out (port of ``apps/run_fusion.py``).

Runs a TUM/ICL sequence directory or a synthetic analytic scene through
``models.slam.SlamSystem`` on the card (``--device cpu`` runs it on the
CPU) and writes:

  out_dir/trajectory_odom.txt     TUM-format odometry trajectory
  out_dir/trajectory_opt.txt      pose-graph-optimized trajectory
  out_dir/state.npz               map + pose checkpoint (loads into either package)
  out_dir/cloud.ply               extracted surface point cloud
  out_dir/metrics.json{l}         per-frame + summary metrics
  out_dir/config.yaml             the configuration (config.json without pyyaml)
  out_dir/render_final.png        final render in --render-mode
  out_dir/render_color.png        fused-color render (--rgb)
  out_dir/render_*.png            half-size display renders (--render-every)

The loop is chunked: ``--chunk`` frames per ``process_chunk`` call (about
a second of frames by default, rounded to the keyframe cadence), one host
fetch per chunk.  PNGs are written by a small zlib encoder, so the app
needs no image library.

Usage:
  python -m topfusion_tpu_torch.apps.run_fusion --synthetic 90 --out /tmp/run
  python -m topfusion_tpu_torch.apps.run_fusion --sequence /data/fr1_desk \\
      --out /tmp/fr1desk --set tsdf.voxel_size=0.005 --render-every 30
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import sys
import time
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB [H, W, 3] (or grey [H, W]) image as a PNG file."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _app_config(args):
    """The configuration file and ``--set`` overrides, with the app's VGA
    operating point where the overrides leave a field alone: 4096 visible
    blocks, the int16 pool, 96 surfels per block, the occlusion cull."""
    from ..config import PipelineConfig
    from ..utils.config_io import apply_overrides, load_config

    cfg = load_config(args.config) if args.config else PipelineConfig()
    cfg = apply_overrides(cfg, args.overrides)

    def unset(name):
        return not any(name in o for o in args.overrides)

    bm, rc = cfg.blockmap, cfg.raycast
    if unset("max_visible_blocks"):
        bm = dataclasses.replace(bm, max_visible_blocks=1 << 12)
    if unset("pool_dtype"):
        bm = dataclasses.replace(bm, pool_dtype="int16")
    if unset("visible_occlusion_cull"):
        bm = dataclasses.replace(bm, visible_occlusion_cull=True)
    if unset("surfels_per_block"):
        rc = dataclasses.replace(rc, surfels_per_block=96)
    cfg = dataclasses.replace(cfg, blockmap=bm, raycast=rc)
    if args.rgb:
        cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=True))
    return cfg


def _poll_key():
    """A key typed on a TTY (then Enter): 'p' pauses, 'q' stops."""
    import select

    if not sys.stdin.isatty():
        return None
    r, _, _ = select.select([sys.stdin], [], [], 0)
    if not r:
        return None
    return (sys.stdin.readline().strip()[:1] or " ").lower()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sequence", help="TUM/ICL sequence directory")
    ap.add_argument("--synthetic", type=int, metavar="N",
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--synthetic-vga", action="store_true",
                    help="synthetic frames at 640x480 (default 320x240)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--config", help="YAML/JSON config file")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="dotted config override, e.g. tsdf.voxel_size=0.01")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames per process_chunk call (default: ~1 second of "
                    "frames, rounded to the keyframe cadence)")
    ap.add_argument("--rgb", action="store_true",
                    help="fuse color and write a color render (synthetic "
                    "scenes render RGB; TUM sequences load it)")
    ap.add_argument("--render-every", type=int, default=0,
                    help="save a half-size display render every N frames")
    ap.add_argument("--no-posegraph", action="store_true",
                    help="odometry only (no keyframes/loop closure)")
    ap.add_argument("--render-mode", default="grey",
                    choices=("grey", "normals", "confidence", "color"),
                    help="shading of render_final.png: phong grey, normal "
                    "colors, fusion-confidence heatmap, or fused voxel color")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; cpu runs "
                    "on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from ..config import CameraConfig
    from ..io.trajectory import ate_rmse
    from ..models.slam import SlamSystem
    from ..ops.pointcloud import extract_pointcloud_blocks, save_ply
    from ..utils.checkpoint import save_run
    from ..utils.config_io import save_config
    from ..utils.device_info import entry_device
    from ..utils.metrics import MetricsLogger

    device = entry_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = _app_config(args)
    camera_overridden = any(
        o.split("=")[0].strip().startswith("camera.") for o in args.overrides
    )

    # Frame source: (depth chunk [N, H, W], rgb chunk or None) pairs.
    gt_poses = None
    timestamps = None
    if args.synthetic:
        from ..io.synthetic import SyntheticScene, orbit_trajectory

        if camera_overridden:
            cam = cfg.camera
        elif args.synthetic_vga:
            cam = CameraConfig(width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        else:
            cam = CameraConfig(width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0)
        cfg = dataclasses.replace(cfg, camera=cam)
        scene = SyntheticScene()
        n_total = args.synthetic
        gt_poses = orbit_trajectory(n_total, max_angle_deg=5.0, max_shift=0.05, seed=2)
        ke = cfg.posegraph.keyframe_every
        chunk = args.chunk or ke * max(1, 30 // ke)
        # The whole synthetic sequence is rendered on the device up front
        # (test-data generation, not the system's work).
        Ts = [torch.as_tensor(T, dtype=torch.float32, device=device) for T in gt_poses]
        frames = torch.stack([scene.render_depth_mm(cam, T) for T in Ts])
        rgbs = torch.stack([scene.render_rgb(cam, T) for T in Ts]) if args.rgb else None
        full = n_total - n_total % chunk

        def chunks():
            for c0 in range(0, full, chunk):
                yield frames[c0:c0 + chunk], None if rgbs is None else rgbs[c0:c0 + chunk]
            for k in range(full, n_total):  # the remainder, a frame at a time
                yield frames[k:k + 1], None if rgbs is None else rgbs[k:k + 1]
    elif args.sequence:
        from ..io.datasets import open_sequence

        seq = open_sequence(args.sequence, with_rgb=args.rgb)
        cfg = dataclasses.replace(cfg, camera=seq.camera)
        timestamps = []
        if seq.groundtruth is not None:
            gt_poses = []
        n_total = len(seq)
        if args.max_frames:
            n_total = min(n_total, args.max_frames)
        ke = cfg.posegraph.keyframe_every
        chunk = args.chunk or ke * max(1, 30 // ke)

        def chunks():
            buf, rgb_buf = [], []
            for k, fr in enumerate(seq):
                if k >= n_total:
                    break
                timestamps.append(fr.timestamp)
                if gt_poses is not None:
                    gt_poses.append(seq.gt_pose_at(fr.timestamp))
                buf.append(np.asarray(fr.depth_mm))
                if args.rgb and fr.rgb is not None:
                    rgb_buf.append(np.asarray(fr.rgb))
                if len(buf) == chunk:
                    yield np.stack(buf), (np.stack(rgb_buf) if rgb_buf else None)
                    buf, rgb_buf = [], []
            for i, d in enumerate(buf):  # the remainder, a frame at a time
                yield d[None], (rgb_buf[i][None] if rgb_buf else None)
    else:
        ap.error("need --sequence or --synthetic")

    try:
        import yaml  # noqa: F401

        config_name = "config.yaml"
    except ImportError:
        config_name = "config.json"
    save_config(os.path.join(args.out, config_name), cfg)

    slam = SlamSystem(cfg, render_in_chunk=bool(args.render_every), device=device)
    metrics = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))

    print(f"warmup on {device} (the CUDA build and every call of the loop)...")
    t_w = time.perf_counter()
    slam.warmup(chunk, with_rgb=args.rgb)
    warmup_s = time.perf_counter() - t_w
    print(f"warmup done in {warmup_s:.1f} s")

    print(f"running {n_total} frames (chunk={chunk})...")
    metrics.reset_timer()
    t_start = time.perf_counter()
    t_after_first = None
    frames_after_first = 0
    done = 0
    next_render = 0
    for depth_chunk, rgb_chunk in chunks():
        if args.max_frames and done >= args.max_frames:
            break
        key = _poll_key()
        if key in ("p", " "):
            print("paused at frame", done, "- press Enter to resume")
            sys.stdin.readline()
        elif key == "q":
            print(f"stopped by user at frame {done}")
            break
        n = depth_chunk.shape[0]
        # Full chunks start on multiples of keyframe_every.
        do_kf = not args.no_posegraph and done % cfg.posegraph.keyframe_every == 0
        infos = slam.process_chunk(depth_chunk, do_kf=do_kf, rgb=rgb_chunk)
        for info in infos:
            metrics.log_frame(info)
        ovf = max(i.get("visible_overflow", 0) for i in infos)
        if ovf > 0:
            print(
                f"WARNING: visible-set overflow: {ovf} allocated blocks truncated by "
                f"blockmap.max_visible_blocks={cfg.blockmap.max_visible_blocks} this "
                f"chunk (silent under-integration); raise the bound for this scene "
                f"density",
                file=sys.stderr,
            )
        done += n
        if t_after_first is None:
            t_after_first = time.perf_counter()
        else:
            frames_after_first += n
        if args.render_every and done > next_render:
            next_render = done + args.render_every - 1
            write_png(os.path.join(args.out, f"render_{done:05d}.png"),
                      slam.last_render[::2, ::2].cpu().numpy())
    t_end = time.perf_counter()

    summary = metrics.summary()
    summary["warmup_s"] = warmup_s
    summary["app_fps_total"] = done / max(t_end - t_start, 1e-9)
    if t_after_first is not None and frames_after_first > 0:
        summary["app_fps_steady"] = frames_after_first / max(t_end - t_after_first, 1e-9)
    summary["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    opt = slam.optimized_trajectory()
    if gt_poses is not None and all(g is not None for g in gt_poses or []):
        gt_list = [np.asarray(g) for g in gt_poses[: len(slam.odom_poses)]]
        summary["ate_odom_m"] = ate_rmse(slam.odom_poses, gt_list)
        summary["ate_opt_m"] = ate_rmse(opt, gt_list)
        print(f"ATE odometry: {summary['ate_odom_m'] * 1000:.1f} mm, "
              f"optimized: {summary['ate_opt_m'] * 1000:.1f} mm")
    summary["loops_closed"] = slam.loops_closed
    print(f"summary: {summary}")

    pc = extract_pointcloud_blocks(slam.state.block_map(), cfg.tsdf, cfg.blockmap)
    n_pts = save_ply(os.path.join(args.out, "cloud.ply"), pc)
    print(f"extracted {n_pts} surface points -> cloud.ply")

    if args.rgb:
        write_png(os.path.join(args.out, "render_color.png"),
                  slam.pipe.render_color(slam.state).cpu().numpy())
        print("color render -> render_color.png")

    render_fns = {
        "grey": lambda: slam.pipe.render(slam.state),
        "normals": lambda: slam.pipe.render_normals(slam.state),
        "confidence": lambda: slam.pipe.render_confidence(slam.state),
        "color": lambda: slam.pipe.render_color(slam.state),
    }
    write_png(os.path.join(args.out, "render_final.png"),
              render_fns[args.render_mode]().cpu().numpy())
    print(f"final {args.render_mode} render -> render_final.png")

    save_run(args.out, slam.state, slam.odom_poses, opt, timestamps, metrics=summary)
    metrics.close()
    print(f"outputs in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
