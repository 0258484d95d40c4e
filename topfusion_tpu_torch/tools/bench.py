"""Benchmark: fused depth frames/s of the port on the card (port of the
JAX package's ``bench.py``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} and, for
the orbit without ``--no-extras``, "pallas_agreement",
"sharded_mesh1_fps" and "sharded_vs_unsharded".  ``vs_baseline`` is
frames/s over 30, the 640x480 sensor rate the reference was built to
keep up with (BASELINE.md).

Protocol, as ``bench.py``'s: the depth frames are rendered to the card
before the timer starts, and the timed region is only fusion steps
chained on the device, with one sync at its end.  ``bench.py`` compiles
a ``lax.scan`` of the step over a chunk of 8 frames; here the step is
captured once as a CUDA graph (``models/captured.CapturedStep``) and a
chunk is 8 replays, with no host sync inside.

Scenarios (``--scenario``):

  orbit    the 8-frame orbit ``orbit_trajectory(8, 3.0, 0.03, seed=1)``:
           two eager bootstrap steps, a warm-up chunk, 6 timed chunks;
           metric ``fused_depth_frames_per_s_per_chip``;
  sweep    forward down ``corridor_scene()`` over ``sweep_trajectory(64)``
           in chunks of 8 from a fresh map (the allocator runs hot every
           frame), the blocks allocated per frame on stderr; metric
           ``fused_sweep_frames_per_s_per_chip``;
  sharded  the orbit through ``ShardedBlockPipeline`` on a world of one
           process (NCCL on the card), its collectives captured with the
           step; metric ``sharded_mesh1_frames_per_s_per_chip``.

``pallas_agreement`` re-runs the card tests that hold the integrate
kernel bit-equal to its plain version (``tests/test_torch_cuda.py``) and
gives "pass", "fail" or "skip", as ``bench.py``'s gate does for the TPU
kernel.

Usage:  python3 -m topfusion_tpu_torch.tools.bench [--scenario orbit|sweep|sharded]
            [--pool-dtype int16|float32|bfloat16] [--no-extras] [--device cpu]

Each scenario is a function ``(cfg, device, ...)`` with ``cfg`` the bench
configuration (``tools/bench_config.py``) unless given; ``detail``, a
dict, receives what the JSON line leaves out: ms per frame, peak memory,
the timed frames' aux and the final state (the sweep's also its blocks
dropped).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BASELINE_FPS = 30.0
ORBIT_FRAMES = 8
PASSES = 6  # timed chunks, as bench.py's n_iters
SWEEP_FRAMES = 64
CHUNK = 8
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
AGREEMENT_TESTS = (
    "tests/test_torch_cuda.py::test_kernel_matches_plain",
    "tests/test_torch_cuda.py::test_kernel_matches_plain_on_odd_lists",
)


def _result(metric: str, fps: float) -> dict:
    return {
        "metric": metric,
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render(cfg, scene, poses, device):
    """[n, H, W] u16 depth frames of ``scene`` at ``poses``, on ``device``."""
    import torch

    return torch.stack([
        scene.render_depth_mm(cfg.camera, torch.as_tensor(T, dtype=torch.float32, device=device))
        for T in poses
    ])


def orbit_frames(cfg, device):
    from ..io.synthetic import SyntheticScene, orbit_trajectory

    poses = orbit_trajectory(ORBIT_FRAMES, max_angle_deg=3.0, max_shift=0.03, seed=1)
    return render(cfg, SyntheticScene(), poses, device)


def _timed(runner, chunks, device, detail) -> float:
    """Seconds to run every chunk through ``runner``, one sync at the end;
    records ms per frame, the peak memory, each chunk's aux and the final
    state in ``detail``."""
    import torch

    n = sum(len(c) for c in chunks)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    auxes = [runner.run(c) for c in chunks]
    _sync(device)
    dt = time.perf_counter() - t0
    if detail is not None:
        if device.type == "cuda":
            # The graph's private pool is reserved, not allocated, between
            # replays: the reserved size is the footprint.
            detail["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
            detail["reserved_mib"] = torch.cuda.memory_reserved(device) / 2**20
        detail.update(frames=n, ms_per_frame=dt * 1000 / n, auxes=auxes, state=runner.state())
    return dt


def _orbit(pipe, cfg, device, passes, detail) -> float:
    """bench.py's orbit protocol on ``pipe``: frames/s."""
    from ..models.captured import CapturedStep

    frames = orbit_frames(cfg, device)
    _sync(device)
    state = pipe.init()
    state, _ = pipe.step(state, frames[0])
    state, _ = pipe.step(state, frames[1])
    runner = CapturedStep(pipe, state)
    runner.run(frames)  # warm-up chunk
    dt = _timed(runner, [frames] * passes, device, detail)
    return passes * len(frames) / dt


def bench_orbit(cfg=None, device="cuda", passes: int = PASSES, detail: dict | None = None) -> dict:
    """Steady state: the 8-frame orbit, whose block working set saturates
    after the warm-up, through ``BlockPipeline``."""
    from ..models.block_pipeline import BlockPipeline
    from ..utils.device_info import entry_device
    from .bench_config import bench_config

    cfg = bench_config() if cfg is None else cfg
    dev = entry_device(device)
    fps = _orbit(BlockPipeline(cfg, dev), cfg, dev, passes, detail)
    return _result("fused_depth_frames_per_s_per_chip", fps)


def bench_sweep(cfg=None, device="cuda", n_frames: int = SWEEP_FRAMES, chunk: int = CHUNK,
                detail: dict | None = None) -> dict:
    """Allocation stress: a forward sweep down the corridor, every chunk
    on never-seen geometry.  The capture is warmed on the first chunk; the
    timed pass is one sweep over all frames from a fresh map."""
    import torch

    from ..io.synthetic import corridor_scene, sweep_trajectory
    from ..models.block_pipeline import BlockPipeline
    from ..models.captured import CapturedStep
    from ..utils.device_info import entry_device
    from .bench_config import bench_config

    cfg = bench_config() if cfg is None else cfg
    dev = entry_device(device)
    frames = render(cfg, corridor_scene(), sweep_trajectory(n_frames), dev)
    chunks = list(frames[: n_frames // chunk * chunk].split(chunk))
    _sync(dev)

    pipe = BlockPipeline(cfg, dev)
    state = pipe.init()
    state, _ = pipe.step(state, frames[0])
    runner = CapturedStep(pipe, state)
    runner.run(chunks[0])

    runner.load(pipe.init())
    inner = {}
    dt = _timed(runner, chunks, dev, inner)
    fps = inner["frames"] / dt
    allocs = torch.cat([a.blocks_allocated for a in inner["auxes"]])
    total = int(inner["auxes"][-1].num_blocks[-1])
    sys.stderr.write(f"sweep: {float(allocs.float().mean()):.0f} blocks allocated/frame, "
                     f"{total} total\n")
    if detail is not None:
        detail.update(inner, num_blocks=total,
                      blocks_dropped=int(sum(int(a.blocks_dropped.sum()) for a in inner["auxes"])))
    return _result("fused_sweep_frames_per_s_per_chip", fps)


def bench_sharded_orbit(cfg=None, device="cuda", passes: int = PASSES, detail: dict | None = None,
                        axis=None) -> dict:
    """The sharded pipeline on a world of one: the overhead of the map axis
    and the sort-last compositing against the unsharded orbit, by the same
    protocol.  Without ``axis`` the world is this process alone
    (``parallel.launch.world_of_one``: NCCL on the card, gloo on the
    CPU)."""
    from ..parallel.block_sharded import ShardedBlockPipeline
    from ..parallel.launch import world_of_one
    from ..utils.device_info import entry_device
    from .bench_config import bench_config

    cfg = bench_config() if cfg is None else cfg
    dev = entry_device(device)
    if axis is None:
        with world_of_one(dev) as axis:
            return bench_sharded_orbit(cfg, dev, passes, detail, axis)
    pipe = ShardedBlockPipeline(cfg, axis, dev)
    fps = _orbit(pipe, cfg, dev, passes, detail)
    if detail is not None:
        detail["backend"] = axis.backend
    return _result("sharded_mesh1_frames_per_s_per_chip", fps)


def run_agreement_gate(timeout: int = 1800) -> str:
    """Re-run the card tests that hold the integrate kernel bit-equal to
    its plain version, so that each bench line carries the proof.  Returns
    'pass' / 'fail' / 'skip' (no card)."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
           "-x", "-q", "-m", "cuda", *AGREEMENT_TESTS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return "fail"
    out = r.stdout + r.stderr
    if r.returncode == 0 and " skipped" in out and " passed" not in out:
        return "skip"
    return "pass" if r.returncode == 0 else "fail"


def main(argv=None) -> int:
    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .bench_config import bench_config
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--scenario", choices=("orbit", "sweep", "sharded"), default="orbit",
        help="orbit = steady-state headline; sweep = continuous-allocation "
        "stress (corridor); sharded = the sharded pipeline on a world of 1",
    )
    ap.add_argument("--pool-dtype", default="int16", choices=("float32", "int16", "bfloat16"),
                    help="voxel pool storage dtype (int16 = the reference's fixed-point "
                    "Voxel_s encoding, bfloat16 = half float)")
    ap.add_argument("--no-extras", action="store_true",
                    help="headline metric only: skip the agreement gate and the sharded "
                    "world-of-1 measurement")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    if dev.type == "cuda":
        sys.stderr.write(nvidia_smi_name_power() + "\n")
    cfg = bench_config(args.pool_dtype)
    if args.scenario == "orbit":
        result = bench_orbit(cfg, dev)
        if not args.no_extras:
            result["pallas_agreement"] = run_agreement_gate() if dev.type == "cuda" else "skip"
            try:
                sh = bench_sharded_orbit(cfg, dev)
                result["sharded_mesh1_fps"] = sh["value"]
                result["sharded_vs_unsharded"] = round(sh["value"] / max(result["value"], 1e-9), 3)
            except Exception as e:  # never lose the headline line
                result["sharded_mesh1_fps"] = f"error: {e}"
    elif args.scenario == "sharded":
        result = bench_sharded_orbit(cfg, dev)
    else:
        result = bench_sweep(cfg, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
