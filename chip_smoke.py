#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``topfusion_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still builds and runs there.

    python3 chip_smoke.py            # one card, the bench configuration

Phases, each of which must pass (else the exit code is 1):

  1. banner: torch / CUDA / nvcc / triton versions, and the card's name
     and power limit from nvidia-smi;
  2. build the CUDA integrate kernels from ``topfusion_tpu_torch/csrc``
     (the compiler's registers and spills are printed);
  3. kernel vs plain PyTorch integrate on the card, on the map after a
     few frames of the bench orbit at the bench configuration (VGA,
     5 mm voxels, 2^16-block map, 4096 visible blocks): the whole pool
     must be bit-equal and num_visible equal, for int16, float32 and
     bfloat16 pools; both are timed over REPEATS calls with CUDA events
     (device time, and wall time with the host's launch cost), L2 flushed
     before each call and, for the wrapper, L2 warm as well; the kernel
     alone is timed with the profiler, beside an empty kernel of the same
     grid (the floor of a launch) and the kernel's bound on this card
     (the bytes it must move over the memory rate, computed from this
     run's counts); a map of 4^3 blocks goes once through the per-voxel
     kernel and is held bit-equal too;
  4. the main path: the 8-frame bench orbit through ``BlockPipeline`` with
     the kernel, asserting every frame tracked, no reset, ATE < 12 mm,
     one launch of the column kernel per frame, and a bit-identical
     trajectory and pool against the same run with the plain integrate;
  5. frames/s over PASSES more passes of the orbit, then one profiled
     pass: kernels and device time per frame, the device's busy share
     and the kernels that take most device time (informational);
  6. display, on the fused map of phase 4: ``render``, ``render_normals``
     and ``render_confidence`` at the tracked pose and ``render`` at 4
     poses orbiting the map off the trajectory; the raycast depth against
     the scene's exact depth, and the ranged 64-step march against the
     full 192-step march from the off-trajectory poses; ms and device
     operations per render;
  7. raycast model maps: the same frames through
     ``model_maps="raycast"`` (guided), every frame tracked, ATE < 12 mm,
     one kernel launch per frame;
  8. color: the orbit through ``step_rgb`` with registered RGB frames and
     a color pool; poses bit-identical to the depth-only run, and
     ``render_color`` against the scene's albedo at the hit points;
  9. point cloud: ``extract_pointcloud_blocks`` on the fused map, the
     points held against the scene's zero level set (99% within two
     voxels, the median within half a voxel), and a PLY file written and
     read back;
 10. dense: the orbit through ``DensePipeline`` at VGA over the package's
     default 256^3 volume of 5 mm voxels (2 x 64 MiB of float32), with the
     full 192-step raycast, with the guided 24-step raycast, and through
     ``step_rgb`` with a 192 MiB color grid: every frame tracked, no
     reset, ATE < 12 mm on each, ``step_rgb`` poses bit-identical to the
     depth-only run; ``render`` and ``render_color`` images; the raycast
     depth against the scene's exact depth; ``extract_pointcloud_dense``
     held against the scene's surface as in phase 9; ms per frame, device
     operations and device time per frame, ms per render, peak memory;
 11. out-of-core sweep: the bench configuration on a corridor, 40 frames
     out (pitched camera, 6 cm steps) and back, first uncapped (2^16
     blocks) to count the scene's blocks N, then with a pool capped at
     the largest power of two below N / 1.2 and a ``HostBlockCache``: every
     frame tracked, no block dropped, blocks on the host, restores on the
     return leg, live + host blocks >= 0.95 N, ATE <= 1.2 x the uncapped
     run's + 0.2 mm, one kernel launch per frame; blocks evicted and
     restored, ms and bytes over PCIe per evict round and restore batch,
     frames/s with and without the cache;
 12. SLAM, at the app's VGA operating point (the ``--synthetic-vga``
     camera, 4096 visible blocks, the int16 pool, K = 96, the occlusion
     cull, the default pose graph: 256 keyframes, 1024 edges, keyframes
     every 10 frames at level 1, PCG 10 x 48, re-integration): (a) an
     80-frame out-and-back (lengthened to 100 or 120 if no loop closes)
     through ``SlamSystem.process_chunk`` in chunks of 30: every frame
     tracked, no reset, no block dropped, a loop closed, optimized ATE <
     12 mm and <= 1.5 x the odometry's + 1 mm, one column-kernel launch
     per frame and per re-fused frame, at most n + 2 host syncs for a chunk
     of n frames without a closure; (b) the same frames with every
     correction rebuilding the map from the keyframes and a 32-frame ring,
     twice: a rebuild, launches = frames + the frames the rebuilds re-fuse,
     both runs' graphs and poses bit-identical, the rebuilt map raycast
     from the corrected pose within a median 3 voxels of the scene, 3
     more frames tracked; then ``detect_loop``, ``_optimize_ex`` and
     ``_reint`` timed on (b)'s graph and map, and one chunk profiled;
     (c) the app as a subprocess, ``--synthetic 60 --synthetic-vga --video
     --orbit-video 8``: exit 0, every output file, optimized ATE < 12 mm,
     video.gif with a half-size image per chunk and orbit.gif with 8
     full-size images of the map, some of it covered;
 13. ICP one-hot: the orbit of phase 4 with ``icp.gather_mode="onehot"``
     (the band gather, ``ops/gather_mm.py``): every frame tracked, no reset,
     ATE < 12 mm, one column-kernel launch per frame, one host sync per
     step; the correspondences the band drops in one level-0 association
     (flat count minus onehot count), the largest pose difference from
     phase 4's flat run, ms per frame, device operations and device time
     per frame;
 14. fy < 0 (the ICL-NUIM convention): the bench configuration with fy
     negated and the scene rendered through it; one integrate call of the
     kernel bit-equal to the plain version, then the orbit: every frame
     tracked, no reset, ATE < 12 mm, one column-kernel launch per frame,
     and ATE < 1.3 x phase 4's + 0.1 mm (tests/test_negative_fy.py's
     acceptance);
 15. the sharded block map (``parallel.ShardedBlockPipeline``, one process
     per shard, started by spawn): (a) a world of one NCCL process over
     the orbit: every frame tracked, the trajectory and every state field
     bit-identical to phase 4's, one column-kernel launch per frame, the
     kernel bit-equal to the plain version on the shard's pool, the
     composited render bit-equal to the single-device march with its
     nearest-voxel weight gate, shaded, that march against the scene's
     exact depth (asserted as in phase 6), and against
     ``BlockPipeline.render``, whose ranged march and trilinear gate
     differ (printed);
     (b) a world of 4 gloo processes sharing the card (gloo takes the
     card's tensors as they are) over the orbit: every frame tracked on every
     rank, ATE < 12 mm, poses within 1 mm and 1e-2 of phase 4's, the
     ranks' poses, model maps and renders identical, no block on two
     shards, the block count within 5% of phase 4's, one launch per frame
     per rank, the kernel bit-equal to plain on each rank's local pool;
     (c) on the same world, the first 32 frames of phase 11's sweep out
     and back, uncapped and then with phase 11's capacity split over the
     shards and a ``ShardedHostCache`` per shard: more blocks than 1.2 x
     that capacity, no block dropped, blocks to the hosts and back, live +
     host >= 0.95 N, ATE <= 1.2 x the uncapped sharded run's + 0.2 mm,
     one launch per frame per rank; each world prints ms/frame,
     collective calls and bytes per frame and host syncs per step, and
     the world of 1 device operations and device time per frame (a
     profiled pass; not in the world of 4, whose four processes
     time-slice the card).
 16. the sharded SLAM system (``parallel/sharded_slam.ShardedSlamSystem``)
     and the rest of ``parallel/``, at the app's VGA operating point:
     (a) a world of one NCCL process over phase 12 (a)'s frames in its
     chunks: trajectory, optimized trajectory, graph, map and counters
     bit-identical to phase 12 (a)'s ``SlamSystem``, one column-kernel
     launch per frame and per re-fused frame, at most n + 3 host syncs
     per chunk of n frames without a closure, every solve
     gn_iters x (cg_iters + 3) collectives of the bytes computed, the
     kernel bit-equal to plain on the shard's pool; ms, collectives and
     bytes per chunk, the solve's ms;
     (c) in the same world, the composed checkpoint saved after the
     second chunk and restored into a fresh system, which runs the last
     chunk (the one that closes the loop) bit-identically to (a); ``run_block_pipeline_demo`` with a
     checkpoint every 2 frames, timed;
     (d) ``make_sharded_pipeline`` at phase 10's full march over the
     orbit: in the world of 1 bit-identical to phase 10's
     ``DensePipeline`` run, in the world of 4 of (b) ATE < 12 mm and the
     ranks' model maps identical; ms/frame, gathers and bytes per frame;
     (e) ``measure_scaling_block`` and ``measure_scaling`` on worlds of 1
     and 4 on this card, printed as overhead and contention, not
     scaling (no efficiency: the processes share one card);
     (b) a world of 4 gloo processes sharing the card over a wider
     out-and-back (60 frames, chunks of 10, every correction rebuilding
     the map from a 10-frame ring) with a ``ShardedHostCache`` per shard
     that keeps half of each shard's pool free, so that fewer blocks stay
     live than the run maps: every frame tracked on every rank, a loop
     closed and the map rebuilt, ``remap_store`` run while blocks sit on
     the hosts (its counts printed), optimized ATE < 12 mm, no block
     dropped, the ranks' trajectories, graphs and renders identical, no
     key on two ranks, one launch per frame and per re-fused frame on
     every rank, the kernel bit-equal to plain on every local pool after
     the rebuild.

The kernel's launch count is set to 0 before each of the stepping paths
(4, 7, 8, the capped sweep of 11, 12 (a) and (b), 13, 14 and, in each
shard's process, 15 (a), (b) and the capped sweep of (c), 16 (a) and (b))
and read after it;
the dense path launches no hand-written kernel (its integrate is XLA in
the JAX package and plain PyTorch here).  What each
phase took is printed.  The last lines are one JSON line of
kernel results, the nvidia-smi name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA,
or without the package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ATE_LIMIT_M = 0.012
FRAMES = 8  # the bench orbit of bench.py:96
PASSES = 6  # timed passes over the orbit, as bench.py:121-128
REPEATS = 20  # timed calls per kernel-vs-plain measurement
KERNEL_SOURCE = "topfusion_tpu_torch/csrc/integrate.cu"
KERNEL_REPLACES = "topfusion_tpu/ops/pallas/integrate_kernel.py:242"
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate, and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
INTEGRATE_OPS_PER_VOXEL = 40  # float operations per voxel of a live entry
ORBIT_VIEWS = 4  # off-trajectory display poses
ORBIT_SWEEP_DEG = 40.0
# Views at which "99% of the common hits within a voxel" is asserted (10
# and 20 degrees off the tracked pose).  At 30 degrees half the image looks
# into space no frame observed and grazes the surfaces that were: 0.989
# there (NVIDIA H100 80GB HBM3), printed and not asserted.
RANGED_WITHIN_VOXEL_VIEWS = (1, 2)
RENDER_REPEATS = 5  # timed calls per display measurement
COLOR_PASSES = 2  # timed passes over the orbit through step_rgb
# Mean absolute error per channel of render_color against the scene's
# albedo at the hit points, in [0, 1] units: after n frames a voxel holds
# n/(n+1) of its observed color (the average runs on the weight the depth
# pass already raised), so 8 frames leave about a ninth of the albedo
# unaccounted for.  Measured 0.135, 0.096, 0.099 (NVIDIA H100 80GB HBM3).
COLOR_MAE_LIMIT = 0.15
DENSE_DIMS = (256, 256, 256)  # the package's default volume (config.py, README.md)
DENSE_ORIGIN = (-0.64, -0.64, 0.4)  # holds the scene: its back wall is at z = 1.6
DENSE_PASSES = 1  # timed passes over the orbit through the dense step
SWEEP_FWD = (40, 56, 72)  # forward frames of the sweep; lengthened if the scene is too small
SWEEP_STEP_M = 0.06
SWEEP_PITCH_RAD = 0.35  # the floor and box tops stay within range down the corridor
SWEEP_FRUSTUM_MAX_M = 2.0  # matches the depth truncation: bounds the per-frame working set
SWEEP_EVICT_BATCH = 1024
SWEEP_RESTORE_BATCH = 512
SLAM_FRAMES = (80, 100, 120)  # out-and-back lengths; lengthened until a loop closes
SLAM_CHUNK = 30  # the app's frames per process_chunk call at keyframe_every = 10
SLAM_RING = 32  # reint_ring of the rebuild run
SLAM_MORE = 3  # frames tracked after the rebuild
SLAM_APP_FRAMES = 60
SLAM_APP_TIMEOUT_S = 600
APP_ORBIT_VIEWS = 8  # --orbit-video of the app's run


def bench_config(pool_dtype: str = "int16"):
    """The JAX package's ``bench.py:make_cfg``: 640x480 at the reference
    intrinsics, 5 mm voxels, mu = 2 cm, 2^16 blocks, 4096 visible
    blocks, occlusion-culled aged visible sets, splat K = 80, ICP
    (10, 5, 4) with bilinear polish, the integrate kernel."""
    from topfusion_tpu_torch.config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        RaycastConfig,
        TSDFConfig,
    )

    return PipelineConfig(
        camera=CameraConfig(),
        icp=ICPConfig(iters=(10, 5, 4)),
        tsdf=TSDFConfig(voxel_size=0.005, trunc_dist=0.02),
        blockmap=BlockMapConfig(
            max_visible_blocks=1 << 12,
            pool_dtype=pool_dtype,
            use_pallas_integrate=True,
            visible_occlusion_cull=True,
        ),
        raycast=RaycastConfig(max_steps=192, surfels_per_block=80),
    )


def with_plain_integrate(cfg):
    return dataclasses.replace(
        cfg, blockmap=dataclasses.replace(cfg.blockmap, use_pallas_integrate=False)
    )


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def banner() -> str:
    import torch

    from topfusion_tpu_torch.ops.cuda.build import find_nvcc
    from topfusion_tpu_torch.utils.device_info import device_banner, nvidia_smi_name_power

    print(device_banner())
    nvcc = find_nvcc()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    print(f"nvcc: {nvcc}: {out.strip().splitlines()[-1] if out.strip() else '?'}")
    try:
        import triton

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}")
    return nvidia_smi_name_power()


def build_kernel() -> None:
    from topfusion_tpu_torch.ops.cuda.build import library_path, load_library

    t0 = time.perf_counter()
    load_library("integrate")
    secs = time.perf_counter() - t0
    print(f"build: integrate kernels ready in {secs:.2f} s")
    log = library_path("integrate").with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())


def render_frames(cfg, poses, device):
    import torch

    from topfusion_tpu_torch.io.synthetic import SyntheticScene

    scene = SyntheticScene()
    return [
        scene.render_depth_mm(cfg.camera, torch.as_tensor(T, dtype=torch.float32, device=device))
        for T in poses
    ]


def run(pipe, state, frames, rgbs=None):
    """Step every frame (with its RGB frame through ``step_rgb`` if
    ``rgbs`` is given); returns (state, [T_wc], [aux])."""
    poses, auxes = [], []
    for i, f in enumerate(frames):
        if rgbs is None:
            state, aux = pipe.step(state, f)
        else:
            state, aux = pipe.step_rgb(state, f, rgbs[i])
        poses.append(state.T_wc)
        auxes.append(aux)
    return state, poses, auxes


def time_calls(fn, repeats: int, flush_l2: bool = True) -> dict:
    """Times of ``fn()`` per call, median over ``repeats`` calls, each after
    the L2 cache was flushed (a 256 MiB random fill, outside the timed span)
    or, with ``flush_l2`` false, with whatever the call before left there.

    ``wall_ms``: between CUDA events around the call on an idle device, so
    the host's launch cost is in it.  ``device_ms``: the same events, but
    with the device held busy (``torch.cuda._sleep``) until the host has
    enqueued the whole call, so the span is the device's work alone.  A
    call whose first event the device reached before the host was done is
    taken again with a longer hold."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()

    def span(hold_cycles: int) -> tuple[float, bool]:
        if flush_l2:
            flush.uniform_()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        late = a.query()  # the device got to ``a`` before the call was enqueued
        b.synchronize()
        return a.elapsed_time(b), late

    walls = [span(0)[0] for _ in range(repeats)]
    devices = []
    hold = 1 << 24  # ~8 ms at the card's clock
    while len(devices) < repeats:
        ms, late = span(hold)
        if late:
            check(hold < 1 << 31, "the host cannot enqueue one call within a 1 s hold")
            hold *= 2
            continue
        devices.append(ms)
    return {"wall_ms": statistics.median(walls), "device_ms": statistics.median(devices)}


def kernel_event_ms(fn, repeats: int, kernel_name: str, flush_l2: bool = True) -> float | None:
    """Median device time of the kernels whose name holds ``kernel_name``
    over ``repeats`` calls (L2 flushed before each unless ``flush_l2`` is
    false), as the profiler records them; None if it records none
    (informational only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            if flush_l2:
                flush.uniform_()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.name]
    return statistics.median(us) / 1000.0 if us else None


def integrate_bound(updated: int, live_voxels: int, elem_size: int, h: int, w: int,
                    num_entries: int) -> dict:
    """The least time the card could take for one integrate call: the
    larger of the bytes it must move (each updated voxel's tsdf and weight
    read once and written once, the depth image, the visible lists and the
    pose read once) over the memory rate, and its float operations (every
    voxel of a live entry is projected and gated) over the float32 rate."""
    nbytes = updated * 4 * elem_size + h * w * 4 + num_entries * (4 + 12 + 1) + 64
    ops = live_voxels * INTEGRATE_OPS_PER_VOXEL
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def empty_kernel_ms(grid: int, block: int) -> float | None:
    """The profiler's median time of an empty kernel at ``grid`` x
    ``block``: what a launch of that size costs the device by itself."""
    import ctypes

    import torch

    from topfusion_tpu_torch.ops.cuda.build import load_library

    fn = load_library("integrate").tf_launch_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(grid, block, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the empty kernel did not launch: CUDA error {err}")

    launch()
    return kernel_event_ms(launch, REPEATS, "empty_kernel", flush_l2=False)


def fmt_ms(x: float | None) -> str:
    return f"{x:.4f} ms" if x is not None else "not measured"


def integrate_inputs(cfg, frames, poses, device):
    """The inputs of one integrate call: the map after 3 of ``frames``
    (plain integrate), allocated for the 4th, with its pose, its depth in
    metres and its visible set."""
    import torch

    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
    from topfusion_tpu_torch.ops.depth import depth_to_meters
    from topfusion_tpu_torch.ops.tsdf_block import allocate_from_depth, visible_blocks

    cfg = with_plain_integrate(cfg)
    cam, tc, bm = cfg.camera, cfg.tsdf, cfg.blockmap
    pipe = BlockPipeline(cfg, device)
    state, _, _ = run(pipe, pipe.init(), frames[:3])
    T = torch.as_tensor(poses[3], dtype=torch.float32, device=device)
    raw = depth_to_meters(frames[3], cfg.preproc.max_sensor_depth)
    m, _ = allocate_from_depth(state.block_map(), cam, tc, bm, T, raw)
    return m, T, raw, visible_blocks(m, cam, tc, bm, T, depth=raw)


def kernel_vs_plain(frames, poses, device) -> dict:
    """Phase 3.  Returns the int16 result (the bench's pool dtype)."""
    import torch

    from topfusion_tpu_torch.ops.blockmap import decode_tsdf
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda, launch_plan
    from topfusion_tpu_torch.ops.tsdf_block import integrate_blocks

    results = {}
    for dtype in ("int16", "float32", "bfloat16"):
        cfg = bench_config(dtype)
        cam, tc, bm = cfg.camera, cfg.tsdf, cfg.blockmap
        m, T, raw, vis = integrate_inputs(cfg, frames, poses, device)

        def fresh():
            return m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone())

        counts = (integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
        mk, nk = integrate_blocks_cuda(fresh(), cam, tc, bm, T, raw, vis)
        mp, np_ = integrate_blocks(fresh(), cam, tc, bm, T, raw, vis)
        torch.cuda.synchronize()
        check((integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
              == (counts[0] + 1, counts[1] + 1), f"{dtype}: the column kernel was not launched")
        n_vis = int(nk)
        updated = int((mp.weight != m.weight).sum())
        equal = torch.equal(mk.tsdf, mp.tsdf) and torch.equal(mk.weight, mp.weight)
        err = float(torch.max(torch.abs(decode_tsdf(mk.tsdf) - decode_tsdf(mp.tsdf))))
        werr = float(torch.max(torch.abs(mk.weight.float() - mp.weight.float())))
        mt, mw = fresh(), fresh()

        def wrapper():
            integrate_blocks_cuda(mt, cam, tc, bm, T, raw, vis)

        w_t = time_calls(wrapper, REPEATS)
        p_t = time_calls(lambda: integrate_blocks(mw, cam, tc, bm, T, raw, vis), REPEATS)
        w_warm = time_calls(wrapper, REPEATS, flush_l2=False)
        k_ms = kernel_event_ms(wrapper, REPEATS, "integrate_columns_kernel")
        k_warm = kernel_event_ms(wrapper, REPEATS, "integrate_columns_kernel", flush_l2=False)
        ms, plain_ms = w_t["device_ms"], p_t["device_ms"]
        h, w = raw.shape
        V = int(vis[0].shape[0])
        bound = integrate_bound(updated, n_vis * bm.block_size ** 3, m.tsdf.element_size(),
                                h, w, V)
        print(
            f"integrate {dtype}: num_visible kernel {n_vis} plain {int(np_)} of V = {V}, "
            f"{updated} voxels updated, pool bit-equal {equal}, "
            f"max |tsdf diff| {err}, max |weight diff| {werr}"
        )
        print(
            f"  device time per call (CUDA events, device held busy, L2 flushed, "
            f"median of {REPEATS}): wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"wrapper with L2 warm {w_warm['device_ms']:.4f} ms; "
            f"wall per call (CUDA events, idle device, median): "
            f"wrapper {w_t['wall_ms']:.4f} ms, plain {p_t['wall_ms']:.4f} ms"
        )
        print(
            f"  the kernel alone (profiler, median of {REPEATS}): L2 flushed {fmt_ms(k_ms)}, "
            f"L2 warm {fmt_ms(k_warm)}; bound {bound['bound_ms']:.5f} ms by {bound['bound_by']} "
            f"({bound['bytes']} B: {bound['bytes_ms']:.5f} ms at {PEAK_BYTES_PER_S / 1e12} TB/s; "
            f"operations {bound['ops_ms']:.5f} ms at {PEAK_FP32_OPS_PER_S / 1e12} TFLOP/s)"
            + (f"; bound / kernel = {bound['bound_ms'] / k_ms:.3f} flushed, "
               f"{bound['bound_ms'] / k_warm:.3f} warm" if k_ms and k_warm else "")
        )
        check(n_vis == int(np_), f"{dtype}: num_visible differs")
        check(n_vis > 1000 and updated > 0, f"{dtype}: trivial comparison")
        check(equal, f"{dtype}: kernel and plain pools differ")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "kernel_ms": k_ms, "bound_ms": bound["bound_ms"],
                          "bound_by": bound["bound_by"]}
    plan = launch_plan(V, bm.block_size)
    print(f"an empty kernel at the integrate grid ({plan.grid} CTAs of {plan.block} threads), "
          f"profiler, median of {REPEATS}: {fmt_ms(empty_kernel_ms(plan.grid, plan.block))}")
    return results["int16"]


def generic_path_check(frames, poses, device) -> None:
    """A map of 4^3 blocks at the bench configuration, allocated from the
    first frame and integrated twice: the per-voxel kernel against the
    plain version, bit-equal over the whole pool after each call."""
    import torch

    from topfusion_tpu_torch.ops.blockmap import make_block_map
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.ops.depth import depth_to_meters
    from topfusion_tpu_torch.ops.tsdf_block import (
        allocate_from_depth,
        integrate_blocks,
        visible_blocks,
    )

    cfg = bench_config("int16")
    cam, tc = cfg.camera, cfg.tsdf
    bm = dataclasses.replace(cfg.blockmap, block_size=4)
    T = torch.as_tensor(poses[0], dtype=torch.float32, device=device)
    raw = depth_to_meters(frames[0], cfg.preproc.max_sensor_depth)
    m, _ = allocate_from_depth(make_block_map(bm, device=device), cam, tc, bm, T, raw)
    vis = visible_blocks(m, cam, tc, bm, T, depth=raw)
    mk = m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone())
    mp = m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone())
    counts = (integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
    for call in range(2):
        _, nk = integrate_blocks_cuda(mk, cam, tc, bm, T, raw, vis)
        _, np_ = integrate_blocks(mp, cam, tc, bm, T, raw, vis)
        torch.cuda.synchronize()
        equal = torch.equal(mk.tsdf, mp.tsdf) and torch.equal(mk.weight, mp.weight)
        updated = int((mp.weight > call).sum())
        print(f"integrate 4^3 blocks (per-voxel kernel), call {call}: num_visible "
              f"{int(nk)}, {updated} voxels updated in every call so far, "
              f"pool bit-equal {equal}")
        check(int(nk) == int(np_) > 1000 and updated > 0, "4^3 blocks: trivial comparison")
        check(equal, "4^3 blocks: kernel and plain pools differ")
    check((integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
          == (counts[0] + 2, counts[1]), "4^3 blocks did not go through the per-voxel kernel")


def counted_run(pipe, frames, rgbs=None):
    """One pass over the frames from a fresh state with the integrate
    kernel's launch counts set to 0 just before and read just after:
    (state, [T_wc], [aux], launches, column launches)."""
    import torch

    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda

    state = pipe.init()
    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = 0
    integrate_blocks_cuda.vector_launches = 0
    state, poses, auxes = run(pipe, state, frames, rgbs)
    torch.cuda.synchronize()
    return (state, poses, auxes, integrate_blocks_cuda.launches,
            integrate_blocks_cuda.vector_launches)


def check_tracked(name, frames, gt, state, est, auxes, launches, vector_launches) -> float:
    """The assertions every stepping path must meet; returns the ATE (m)."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.io.trajectory import ate_rmse

    est_np = [T.cpu().numpy() for T in est]
    ate = ate_rmse(est_np, gt, align=False)
    print(f"{name}: {len(frames)} frames, ATE {ate * 1000:.3f} mm, "
          f"resets {int(state.resets)}, kernel launches {launches} "
          f"({vector_launches} of the column kernel)")
    check(all(bool(a.ok) for a in auxes), f"{name}: a frame failed to track")
    check(int(state.resets) == 0, f"{name}: the pipeline reset")
    check(ate < ATE_LIMIT_M, f"{name}: ATE {ate} m >= {ATE_LIMIT_M} m")
    check(launches == len(frames), f"{name}: {launches} kernel launches for {len(frames)} frames")
    check(vector_launches == launches, f"{name}: did not take the column kernel")
    check(int(state.num_blocks) > 0, f"{name}: no blocks allocated")
    check(all(int(a.blocks_dropped) == 0 for a in auxes), f"{name}: blocks dropped")
    check(all(np.isfinite(T).all() for T in est_np), f"{name}: non-finite pose")
    check(all(bool(torch.isfinite(p).all()) for p in state.model_points),
          f"{name}: non-finite model map")
    return ate


def main_path(frames, poses, device):
    """Phases 4 and 5.  Returns (pipeline, fused state, [T_wc], kernel
    launches of the main-path run, (device operations, device ms) per
    frame of the profiled pass)."""
    import torch

    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline

    cfg = bench_config("int16")
    pipe = BlockPipeline(cfg, device)
    state, est, auxes, launches, vector_launches = counted_run(pipe, frames)
    for i, a in enumerate(auxes):
        print(
            f"frame {i}: ok {bool(a.ok)} blocks {int(a.num_blocks)} "
            f"allocated {int(a.blocks_allocated)} visible {int(a.num_visible)} "
            f"inliers {int(a.num_inliers)} residual {float(a.residual):.6f} "
            f"dropped {int(a.blocks_dropped)} visible_overflow {int(a.visible_overflow)}"
        )
    check_tracked("main path", frames, poses, state, est, auxes, launches, vector_launches)
    fused = state

    plain = BlockPipeline(with_plain_integrate(cfg), device)
    pstate, pest, _ = run(plain, plain.init(), frames)
    same_poses = all(torch.equal(a, b) for a, b in zip(est, pest))
    same_pool = torch.equal(state.tsdf, pstate.tsdf) and torch.equal(state.weight, pstate.weight)
    print(f"plain-integrate run: poses bit-identical {same_poses}, pool bit-identical {same_pool}")
    check(same_poses and same_pool, "kernel and plain runs differ")

    # Phase 5: throughput (informational, not a benchmark).
    state, _, _ = run(pipe, state, frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PASSES):
        state, _, _ = run(pipe, state, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"throughput: {PASSES * len(frames) / dt:.2f} frames/s over {PASSES} passes "
          f"of {len(frames)} frames ({dt * 1000 / (PASSES * len(frames)):.2f} ms/frame)")
    return pipe, fused, est, launches, profile_pass(pipe, state, frames)


def profiled(fn):
    """``fn()`` once under the profiler: (device operations, their summed
    device time in ms, the wall time in ms with the profiler's own cost in
    it, device microseconds by kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    us_by_name = collections.Counter()
    ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us_by_name[e.name] += e.time_range.elapsed_us()
            ops += 1
    return ops, sum(us_by_name.values()) / 1000, wall_ms, us_by_name


def profile_pass(pipe, state, frames) -> tuple:
    """One pass over the frames under the profiler: device operations and
    their summed device time per frame, the device's busy share of the
    pass's wall time (which the profiler's own cost inflates), and the
    five kernels that take the most device time.  Returns (device
    operations, device ms) per frame."""
    n = len(frames)
    ops, device_ms, wall_ms, us_by_name = profiled(lambda: run(pipe, state, frames))
    if device_ms == 0.0:
        print("profiled pass: the profiler recorded no device time (not measured)")
        return ops / n, None
    print(f"profiled pass: {ops / n:.1f} device ops/frame, device time "
          f"{device_ms / n:.3f} ms/frame, wall {wall_ms / n:.3f} ms/frame, "
          f"device busy share {device_ms / wall_ms:.4f}")
    for name, us in us_by_name.most_common(5):
        print(f"  {us / 1000 / n:8.3f} ms/frame  {name[:100]}")
    return ops / n, device_ms / n


def measure(name: str, fn, repeats: int = RENDER_REPEATS) -> None:
    """Time, device operations and peak memory of one display or export
    call on the warm card (informational; nothing is asserted on them).
    The time is between CUDA events around the call on an idle device, so
    the host's launch cost is in it; the device's own work is the
    profiler's summed kernel time.  (``time_calls``' device span cannot
    be taken here: a call of thousands of operations overflows the launch
    queue while the device is held busy.)"""
    import torch

    fn()
    spans = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    ops, device_ms, _, _ = profiled(fn)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: {statistics.median(spans):.3f} ms per call (CUDA events around the call "
          f"on an idle device, median of {repeats}; min {min(spans):.3f}, max {max(spans):.3f}), "
          f"{ops} device operations with {device_ms:.3f} ms of device time (profiler), "
          f"peak memory {peak / 2**20:.1f} MiB of which {(peak - base) / 2**20:.1f} MiB "
          f"the call's own")


def display_phase(pipe, state, device) -> None:
    """Phase 6, on the fused state of the main path."""
    import torch

    from topfusion_tpu_torch.geometry.viewpath import map_centroid, orbit_path
    from topfusion_tpu_torch.io.synthetic import SyntheticScene
    from topfusion_tpu_torch.ops.tsdf_block import raycast_blocks

    cfg = pipe.cfg
    cam, tc, bm = cfg.camera, cfg.tsdf, cfg.blockmap
    voxel = tc.voxel_size
    shape = (cam.height, cam.width, 3)
    T = state.T_wc
    center = map_centroid(state.block_coords.cpu().numpy(), int(state.num_blocks),
                          bm.block_size * voxel)
    views = orbit_path(center, T.cpu().numpy(), ORBIT_VIEWS, max_sweep_deg=ORBIT_SWEEP_DEG)
    print(f"display: map centroid {center.tolist()}, {ORBIT_VIEWS} views over "
          f"{ORBIT_SWEEP_DEG} degrees around it")

    def grey(img):
        # Shaded pixels are grey; the background gradient is bluish.
        return img[..., 0] == img[..., 2]

    def colored(img):
        return img.sum(-1) > 0

    rc = pipe._free_view_raycast(state, T)
    hit_share = float(rc.hit.float().mean())
    images = [("render", pipe.render(state), grey),
              ("render_normals", pipe.render_normals(state), colored),
              ("render_confidence", pipe.render_confidence(state), colored)]
    images += [(f"render view {i}", pipe.render(state, V), grey) for i, V in enumerate(views)]
    torch.cuda.synchronize()
    for name, img, lit in images:
        check(img.dtype == torch.uint8 and tuple(img.shape) == shape and img.device == device,
              f"{name}: not a uint8 {shape} image on the card")
        shown = float(lit(img).float().mean())
        print(f"  {name}: lit share {shown:.4f}")
        check(0.3 < shown <= 1.0, f"{name}: lit share {shown} is not plausible")
    check(abs(float(grey(images[0][1]).float().mean()) - hit_share) < 0.02,
          "render: the lit share is not the raycast's hit share")

    # The raycast at the tracked pose against the scene's exact depth.
    gt = SyntheticScene().render_depth(cam, T)
    mask = rc.hit & (gt > 0) & (gt < 1.5)
    err = torch.abs(rc.depth - gt)[mask]
    cover, med = float(mask.float().mean()), float(err.median())
    print(f"  tracked pose: hit share {hit_share:.4f}, {cover:.4f} of the image compared with "
          f"the exact depth, median |error| {med * 1000:.3f} mm ({med / voxel:.3f} voxels)")
    check(cover > 0.3, f"the raycast covers {cover} of the image")
    check(med < 2 * voxel, f"median raycast depth error {med} m >= 2 voxels")
    check(bool(torch.isfinite(rc.points).all()) and bool(torch.isfinite(rc.normals).all()),
          "non-finite raycast")

    # The ranged march against the full march from off the trajectory.
    m = state.block_map()
    for i in range(1, ORBIT_VIEWS):
        V = torch.as_tensor(views[i], dtype=torch.float32, device=device)
        ranged = pipe._free_view_raycast(state, V)
        full = raycast_blocks(m, cam, tc, bm, cfg.raycast, V)
        both = full.hit & ranged.hit
        dd = torch.abs(full.depth - ranged.depth)[both]
        flips = float((full.hit ^ ranged.hit).float().mean())
        med, within = float(dd.median()), float((dd < voxel).float().mean())
        print(f"  view {i}: ranged ({cfg.raycast.ranged_max_steps} steps) against full "
              f"({cfg.raycast.max_steps} steps): hit differs on {flips:.5f} of the pixels, "
              f"hit share {float(ranged.hit.float().mean()):.4f}, median depth difference "
              f"{med / voxel:.4f} voxels, {within:.5f} within one voxel")
        check(flips < 0.02, f"view {i}: ranged and full hits differ on {flips} of the pixels")
        check(med < 0.1 * voxel, f"view {i}: ranged and full depths differ by {med} m in the median")
        if i in RANGED_WITHIN_VOXEL_VIEWS:
            check(within > 0.99, f"view {i}: only {within} of the common hits agree within a voxel")

    measure("render (tracked pose)", lambda: pipe.render(state))
    measure(f"render (view {ORBIT_VIEWS - 1})", lambda: pipe.render(state, V))
    measure("full-march raycast", lambda: raycast_blocks(m, cam, tc, bm, cfg.raycast, V),
            repeats=3)


def raycast_model_maps_phase(frames, poses, device) -> int:
    """Phase 7.  Returns the kernel launches of the run."""
    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline

    cfg = bench_config("int16")
    cfg = dataclasses.replace(cfg, raycast=dataclasses.replace(
        cfg.raycast, model_maps="raycast", guided=True))
    pipe = BlockPipeline(cfg, device)
    state, est, auxes, launches, vector_launches = counted_run(pipe, frames)
    check_tracked("raycast model maps (guided)", frames, poses, state, est, auxes,
                  launches, vector_launches)
    ops, device_ms, wall_ms, _ = profiled(lambda: run(pipe, state, frames))
    n = len(frames)
    print(f"  profiled pass: {ops / n:.1f} device ops/frame, device time "
          f"{device_ms / n:.3f} ms/frame, wall {wall_ms / n:.3f} ms/frame")
    return launches


def color_phase(frames, rgbs, poses, depth_only_est, device) -> int:
    """Phase 8.  Returns the kernel launches of the run."""
    import torch

    from topfusion_tpu_torch.io.synthetic import SyntheticScene
    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
    from topfusion_tpu_torch.ops.blockmap import decode_tsdf

    cfg = bench_config("int16")
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=True))
    scene = SyntheticScene()
    pipe = BlockPipeline(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, est, auxes, launches, vector_launches = counted_run(pipe, frames, rgbs)
    peak = torch.cuda.max_memory_allocated()
    check_tracked("color (step_rgb)", frames, poses, state, est, auxes, launches, vector_launches)
    same = all(torch.equal(a, b) for a, b in zip(est, depth_only_est))
    print(f"  poses bit-identical to the depth-only run: {same}; color pool "
          f"{tuple(state.color.shape)} {state.color.dtype} = "
          f"{state.color.numel() * state.color.element_size() / 2**20:.1f} MiB; peak memory "
          f"of the run {peak / 2**20:.1f} MiB")
    check(same, "color fusion changed the trajectory")
    top = float(decode_tsdf(state.color).abs().max())
    check(top > 0.5, f"the color pool holds no color (max {top})")

    img = pipe.render_color(state)
    rc = pipe._free_view_raycast(state, state.T_wc)
    check(img.dtype == torch.uint8 and tuple(img.shape) == (cfg.camera.height, cfg.camera.width, 3),
          "render_color: not a uint8 image of the camera's size")
    lit = int((img.sum(-1) > 30).sum())
    albedo = scene.color_at(rc.points)
    err = torch.abs(img.to(torch.float32) / 255.0 - albedo)[rc.hit]
    mae = err.mean(0)
    ratio = float((img.to(torch.float32).sum(-1)[rc.hit] / 255.0 / albedo.sum(-1)[rc.hit]).median())
    print(f"  render_color: {lit} lit pixels, hit share {float(rc.hit.float().mean()):.4f}, "
          f"mean |error| per channel against the albedo {[round(float(x), 5) for x in mae]}, "
          f"median brightness ratio {ratio:.4f} (limit on the error {COLOR_MAE_LIMIT})")
    check(lit > 50, f"render_color lit {lit} pixels")
    check(float(mae.max()) < COLOR_MAE_LIMIT, f"color error {mae.tolist()} per channel")

    # Frames/s with color (informational).
    state, _, _ = run(pipe, state, frames, rgbs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COLOR_PASSES):
        state, _, _ = run(pipe, state, frames, rgbs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = COLOR_PASSES * len(frames)
    ops, device_ms, _, _ = profiled(lambda: run(pipe, state, frames, rgbs))
    print(f"  step_rgb: {dt * 1000 / n:.2f} ms/frame ({n / dt:.2f} frames/s) over "
          f"{COLOR_PASSES} passes; profiled pass: {ops / len(frames):.1f} device ops/frame, "
          f"device time {device_ms / len(frames):.3f} ms/frame")
    measure("render_color", lambda: pipe.render_color(state))
    return launches


def pointcloud_phase(pipe, state) -> None:
    """Phase 9, on the fused state of the main path."""
    import os

    import torch

    from topfusion_tpu_torch.io.synthetic import SyntheticScene
    from topfusion_tpu_torch.ops.pointcloud import extract_pointcloud_blocks, save_ply

    cfg = pipe.cfg
    voxel = cfg.tsdf.voxel_size
    m = state.block_map()
    pc = extract_pointcloud_blocks(m, cfg.tsdf, cfg.blockmap)
    torch.cuda.synchronize()
    count = int(pc.count)
    check(count > 0 and int(pc.valid.sum()) == count, f"point cloud: count {count}")
    p = pc.points[pc.valid]
    d = SyntheticScene().sdf(p).abs()
    near = float((d < voxel).float().mean())
    far = float((d < 2 * voxel).float().mean())
    print(f"point cloud: {count} points of {pc.points.shape[0]} from {int(state.num_blocks)} "
          f"blocks; |sdf| median {float(d.median()) * 1000:.3f} mm, within one voxel "
          f"({voxel * 1000:.1f} mm) {near:.5f}, within two {far:.5f}")
    check(bool(torch.isfinite(p).all()), "point cloud: non-finite point")
    # A point starts at a voxel centre within one voxel of the fused
    # surface and moves by less than a voxel along the gradient, which
    # wraps around inside a block (as in the JAX package): at block
    # borders it may move the wrong way.  So two voxels bound it, and one
    # voxel holds only for 0.872 of the points (NVIDIA H100 80GB HBM3).
    check(far >= 0.99, f"only {far} of the points lie within two voxels of the surface")
    check(float(d.median()) < 0.5 * voxel, "the median point is half a voxel off the surface")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.ply")
        t0 = time.perf_counter()
        written = save_ply(path, pc)
        secs = time.perf_counter() - t0
        with open(path) as f:
            header = [next(f).strip() for _ in range(10)]
            rows = sum(1 for _ in f)
        size = os.path.getsize(path)
    print(f"  save_ply: {written} vertices, {size / 2**20:.1f} MiB in {secs:.2f} s; "
          f"header says '{header[2]}', {rows} rows read back")
    check(written == count and header[2] == f"element vertex {count}" and rows == count,
          "the PLY file does not hold the cloud")
    measure("extract_pointcloud_blocks",
            lambda: extract_pointcloud_blocks(m, cfg.tsdf, cfg.blockmap), repeats=3)


def dense_config(guided: bool = False, use_color: bool = False):
    """The bench configuration over the default dense volume."""
    from topfusion_tpu_torch.config import DenseVolumeConfig

    cfg = bench_config()
    return dataclasses.replace(
        cfg,
        dense=DenseVolumeConfig(dims=DENSE_DIMS, origin=DENSE_ORIGIN),
        tsdf=dataclasses.replace(cfg.tsdf, use_color=use_color),
        raycast=dataclasses.replace(cfg.raycast, guided=guided),
    )


def timed_passes(pipe, state, frames, passes, rgbs=None):
    """ms per frame on the host's clock over ``passes`` synced passes
    (``state`` comes from a pass that warmed the card), then one profiled
    pass: (ms/frame, device operations per frame, device ms per frame,
    peak memory in bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(passes):
        state, _, _ = run(pipe, state, frames, rgbs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / (passes * len(frames))
    peak = torch.cuda.max_memory_allocated()
    ops, device_ms, _, _ = profiled(lambda: run(pipe, state, frames, rgbs))
    return ms, ops / len(frames), device_ms / len(frames), peak


def dense_phase(frames, rgbs, poses, device) -> dict:
    """Phase 10.  Returns the full march's trajectory and state digest
    for phase 16 (d)."""
    import numpy as np
    import torch

    from topfusion_tpu_torch import DensePipeline
    from topfusion_tpu_torch.io.synthetic import SyntheticScene
    from topfusion_tpu_torch.io.trajectory import ate_rmse
    from topfusion_tpu_torch.ops.pointcloud import extract_pointcloud_dense
    from topfusion_tpu_torch.ops.tsdf_dense import raycast_dense

    scene = SyntheticScene()
    results = {}
    for name, guided, color in (("full march", False, False), ("guided", True, False),
                                ("step_rgb", False, True)):
        cfg = dense_config(guided, color)
        pipe = DensePipeline(cfg, device)
        c = rgbs if color else None
        state, est, auxes = run(pipe, pipe.init(), frames, c)
        torch.cuda.synchronize()
        est_np = [T.cpu().numpy() for T in est]
        ate = ate_rmse(est_np, poses, align=False)
        inl = [int(a.num_inliers) for a in auxes[1:]]
        ms, ops, device_ms, peak = timed_passes(pipe, state, frames, DENSE_PASSES, c)
        print(f"dense {name}: {len(frames)} frames, ATE {ate * 1000:.3f} mm, resets "
              f"{int(state.resets)}, inliers {min(inl)}-{max(inl)}; {ms:.2f} ms/frame "
              f"({1000 / ms:.2f} frames/s) over {DENSE_PASSES} passes; profiled pass: "
              f"{ops:.1f} device ops/frame, device time {device_ms:.3f} ms/frame; peak memory "
              f"of the passes {peak / 2**20:.1f} MiB")
        check(all(bool(a.ok) for a in auxes), f"dense {name}: a frame failed to track")
        check(int(state.resets) == 0 and int(state.frame) == len(frames),
              f"dense {name}: the pipeline reset")
        check(ate < ATE_LIMIT_M, f"dense {name}: ATE {ate} m >= {ATE_LIMIT_M} m")
        check(all(np.isfinite(T).all() for T in est_np), f"dense {name}: non-finite pose")
        check(all(bool(torch.isfinite(p).all()) for p in state.model_points),
              f"dense {name}: non-finite model map")
        results[name] = (cfg, pipe, state, est)

    cfg, pipe, state, est = results["full march"]
    full = dict(poses=[T.cpu().numpy() for T in est], digest=state_digest(state))
    _, cpipe, cstate, cest = results["step_rgb"]
    same = all(torch.equal(a, b) for a, b in zip(est, cest))
    top = float(cstate.color.max())
    print(f"  step_rgb poses bit-identical to the depth-only run: {same}; color grid "
          f"{tuple(cstate.color.shape)} = {cstate.color.numel() * 4 / 2**20:.1f} MiB, max {top:.3f}; "
          f"volume {tuple(state.tsdf.shape)} = 2 x {state.tsdf.numel() * 4 / 2**20:.1f} MiB")
    check(same, "dense: color fusion changed the trajectory")
    check(top > 0.5, f"dense: the color grid holds no color (max {top})")

    cam, voxel = cfg.camera, cfg.tsdf.voxel_size
    shape = (cam.height, cam.width, 3)
    for what, img in (("render", pipe.render(state)), ("render_color", cpipe.render_color(cstate))):
        std = float(img.to(torch.float32).std())
        print(f"  dense {what}: {tuple(img.shape)} {img.dtype}, std {std:.2f}, "
              f"lit share {float((img.sum(-1) > 0).float().mean()):.4f}")
        check(img.dtype == torch.uint8 and tuple(img.shape) == shape and img.device == device,
              f"dense {what}: not a uint8 {shape} image on the card")
        check(std > 5, f"dense {what}: a constant image")

    # The raycast at the tracked pose against the scene's exact depth.
    T = state.T_wc
    rc = raycast_dense(state.volume(), cam, cfg.tsdf, cfg.dense, cfg.raycast, T)
    gt = scene.render_depth(cam, T)
    mask = rc.hit & (gt > 0) & (gt < 1.5)
    err = torch.abs(rc.depth - gt)[mask]
    cover, med = float(mask.float().mean()), float(err.median())
    print(f"  dense raycast at the tracked pose: hit share {float(rc.hit.float().mean()):.4f}, "
          f"{cover:.4f} of the image compared with the exact depth, median |error| "
          f"{med * 1000:.3f} mm ({med / voxel:.3f} voxels)")
    check(cover > 0.3, f"the dense raycast covers {cover} of the image")
    check(med < 2 * voxel, f"median dense raycast depth error {med} m >= 2 voxels")
    check(bool(torch.isfinite(rc.points).all()) and bool(torch.isfinite(rc.normals).all()),
          "non-finite dense raycast")

    pc = extract_pointcloud_dense(state.volume(), cfg.tsdf, cfg.dense)
    torch.cuda.synchronize()
    count = int(pc.count)
    check(count > 0 and int(pc.valid.sum()) == count, f"dense point cloud: count {count}")
    p = pc.points[pc.valid]
    d = scene.sdf(p).abs()
    near = float((d < voxel).float().mean())
    far = float((d < 2 * voxel).float().mean())
    print(f"  dense point cloud: {count} points of {pc.points.shape[0]}; |sdf| median "
          f"{float(d.median()) * 1000:.3f} mm, within one voxel ({voxel * 1000:.1f} mm) "
          f"{near:.5f}, within two {far:.5f}")
    check(bool(torch.isfinite(p).all()), "dense point cloud: non-finite point")
    check(far >= 0.99, f"only {far} of the dense points lie within two voxels of the surface")
    check(float(d.median()) < 0.5 * voxel, "the median dense point is half a voxel off the surface")

    measure("dense render", lambda: pipe.render(state), repeats=3)
    measure("dense render_color", lambda: cpipe.render_color(cstate), repeats=3)
    measure("extract_pointcloud_dense",
            lambda: extract_pointcloud_dense(state.volume(), cfg.tsdf, cfg.dense), repeats=3)
    return full


def sweep_config(capacity: int):
    """The bench configuration with the frustum cut to the depth
    truncation and a pool of ``capacity`` blocks."""
    cfg = bench_config("int16")
    return dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, view_frustum_max=SWEEP_FRUSTUM_MAX_M),
        blockmap=dataclasses.replace(cfg.blockmap, capacity=capacity),
    )


def sweep_frames(n_fwd: int, device):
    """(ground truth relative to the first pose, depth frames) of the
    corridor sweep: ``n_fwd`` frames out and back the same way."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.geometry.se3 import se3_exp
    from topfusion_tpu_torch.io.synthetic import corridor_scene, sweep_trajectory

    cam = bench_config().camera
    pitch = se3_exp(torch.tensor([SWEEP_PITCH_RAD, 0, 0, 0, 0, 0])).numpy()
    scene = corridor_scene(length_m=9.0, box_every=0.35)
    fwd = [T @ pitch for T in sweep_trajectory(n_fwd, step_m=SWEEP_STEP_M)]
    out = [scene.render_depth_mm(cam, torch.as_tensor(T, dtype=torch.float32, device=device))
           for T in fwd]
    back = list(range(n_fwd)) + list(range(n_fwd - 1))[::-1]
    inv0 = np.linalg.inv(fwd[0].astype(np.float64))
    return [(inv0 @ fwd[i]).astype(np.float32) for i in back], [out[i] for i in back]


def run_sweep(cfg, frames, device, cache=None) -> dict:
    """The loop of the JAX package's out-of-core test: restore before each
    step from the last pose, evict after it, and carry the aged visible
    list through every compaction.  Times are on the host's clock around
    device syncs."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline

    pipe = BlockPipeline(cfg, device)
    state = pipe.init()
    r = dict(poses=[], auxes=[], restored=[], evicted=[], restore_ms=[], evict_ms=[])
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for f in frames:
        if cache is not None:
            n0 = cache.n_host_blocks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T_pred = r["poses"][-1] if r["poses"] else np.eye(4, dtype=np.float32)
            state = pipe.write_map(state, cache.before_step(state.block_map(), T_pred))
            torch.cuda.synchronize()
            r["restore_ms"].append((time.perf_counter() - t0) * 1000)
            r["restored"].append(n0 - cache.n_host_blocks)
        state, aux = pipe.step(state, f)
        r["poses"].append(state.T_wc.cpu().numpy())
        r["auxes"].append(aux)
        if cache is not None:
            n0 = cache.n_host_blocks
            t0 = time.perf_counter()
            m, remap = cache.after_step(state.block_map(), state.vis_slots)
            state = pipe.write_map(state, m)
            if remap is not None:
                vs = state.vis_slots
                state = state._replace(
                    vis_slots=torch.where(vs >= 0, remap[vs.clamp(min=0).long()], -1))
            torch.cuda.synchronize()
            r["evict_ms"].append((time.perf_counter() - t0) * 1000)
            r["evicted"].append(cache.n_host_blocks - n0)
    torch.cuda.synchronize()
    r["seconds"] = time.perf_counter() - t_start
    r["state"] = state
    return r


def swap_phase(device) -> tuple:
    """Phase 11.  Returns the kernel launches of the capped sweep, and the
    sweep (ground truth, frames, capped capacity) for phase 15 (c)."""
    import torch

    from topfusion_tpu_torch.io.trajectory import ate_rmse
    from topfusion_tpu_torch.models.host_cache import HostBlockCache
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda

    headroom = SWEEP_EVICT_BATCH + SWEEP_RESTORE_BATCH
    for n_fwd in SWEEP_FWD:
        t0 = time.perf_counter()
        gt, frames = sweep_frames(n_fwd, device)
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
        big = sweep_config(1 << 16)
        run_sweep(big, frames[:3], device)  # warm the allocator and the kernels
        ref = run_sweep(big, frames, device)
        total = int(ref["state"].num_blocks)
        vis = max(int(a.num_visible) for a in ref["auxes"])
        alloc = max(int(a.blocks_allocated) for a in ref["auxes"][1:])
        overflow = sum(int(a.visible_overflow) > 0 for a in ref["auxes"])
        ate_ref = ate_rmse(ref["poses"], gt, align=False)
        # The largest capacity the map admits (a power of two: its hash
        # masks with capacity - 1) with N > 1.2 x capacity.
        cap = 1
        while 1.2 * (2 * cap) < total:
            cap *= 2
        print(f"sweep, {n_fwd} frames out and {n_fwd - 1} back (rendered in {t_render:.1f} s): "
              f"uncapped run at 2^16 blocks: N = {total} blocks, at most {vis} visible and "
              f"{alloc} allocated in a frame, visible_overflow on {overflow} frames, ATE "
              f"{ate_ref * 1000:.3f} mm, {len(frames) / ref['seconds']:.2f} frames/s; "
              f"capped capacity {cap} (free headroom {headroom})")
        check(all(bool(a.ok) for a in ref["auxes"]), "uncapped sweep: a frame failed to track")
        check(all(int(a.blocks_dropped) == 0 for a in ref["auxes"]), "uncapped sweep: blocks dropped")
        # The slots the cache keeps free must take a frame's new blocks and
        # a restore batch, and the rest of the pool the visible set.
        if headroom >= alloc + SWEEP_RESTORE_BATCH and cap - headroom >= vis:
            break
        print("  the working set does not fit under such a capacity: a longer sweep")
    else:
        raise AssertionError("no capacity with N > 1.2 x capacity holds the working set")
    check(total > 1.2 * cap, f"premise: {total} blocks <= 1.2 x {cap}")

    small = sweep_config(cap)
    cache = HostBlockCache(small.blockmap, small.tsdf, small.camera,
                           evict_batch=SWEEP_EVICT_BATCH, restore_batch=SWEEP_RESTORE_BATCH,
                           device=device)
    check(cache.headroom == headroom, "the cache's headroom is not the planned one")
    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = 0
    integrate_blocks_cuda.vector_launches = 0
    got = run_sweep(small, frames, device, cache)
    launches, vector = integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches
    live = int(got["state"].num_blocks)
    ate = ate_rmse(got["poses"], gt, align=False)
    dropped = sum(int(a.blocks_dropped) for a in got["auxes"])
    evicted, restored = sum(got["evicted"]), sum(got["restored"])
    restored_back = sum(got["restored"][n_fwd:])
    print(f"  capped run with the host cache: ATE {ate * 1000:.3f} mm, blocks dropped {dropped}, "
          f"live {live} + host {cache.n_host_blocks} = {live + cache.n_host_blocks} of N = {total}; "
          f"{evicted} blocks evicted, {restored} restored ({restored_back} on the return leg); "
          f"{len(frames) / got['seconds']:.2f} frames/s; kernel launches {launches} "
          f"({vector} of the column kernel) for {len(frames)} frames")

    elem = got["state"].tsdf.element_size()
    block_bytes = 2 * small.blockmap.block_size ** 3 * elem + 12 + 1
    ev = [(ms, n) for ms, n in zip(got["evict_ms"], got["evicted"]) if n > 0]
    rs = [(ms, n) for ms, n in zip(got["restore_ms"], got["restored"]) if n > 0]
    idle = [ms for ms, n in zip(got["evict_ms"], got["evicted"]) if n == 0]
    if ev:
        rounds = sum(-(-n // SWEEP_EVICT_BATCH) for _, n in ev)
        print(f"  evict: {len(ev)} calls of after_step evicted, in {rounds} rounds of up to "
              f"{SWEEP_EVICT_BATCH} blocks: median {statistics.median(m for m, _ in ev):.2f} ms per "
              f"call (max {max(m for m, _ in ev):.2f}), {sum(m for m, _ in ev) / rounds:.2f} ms per "
              f"round, {statistics.median(n for _, n in ev)} blocks per call in the median; a round "
              f"copies {SWEEP_EVICT_BATCH * block_bytes + cap * 4} B to the host (the padded batch "
              f"and the remap) and {SWEEP_EVICT_BATCH * 4} B to the card; a call that evicts "
              f"nothing {statistics.median(idle) if idle else 0.0:.2f} ms")
    if rs:
        print(f"  restore: {len(rs)} batches of up to {SWEEP_RESTORE_BATCH} blocks: median "
              f"{statistics.median(m for m, _ in rs):.2f} ms per batch (max "
              f"{max(m for m, _ in rs):.2f}), {statistics.median(n for _, n in rs)} blocks per "
              f"batch in the median; a batch copies {SWEEP_RESTORE_BATCH * (block_bytes + 3 * elem)} "
              f"B to the card and {SWEEP_RESTORE_BATCH} B back")
    check(all(bool(a.ok) for a in got["auxes"]), "capped sweep: a frame failed to track")
    check(int(got["state"].resets) == 0, "capped sweep: the pipeline reset")
    check(dropped == 0, f"capped sweep: {dropped} blocks dropped despite swapping")
    check(cache.n_host_blocks > 0, "capped sweep: nothing on the host")
    check(live + cache.n_host_blocks >= int(0.95 * total),
          f"capped sweep: live + host = {live + cache.n_host_blocks} < 0.95 x {total}")
    check(ate <= 1.2 * ate_ref + 2e-4, f"capped sweep: ATE {ate} m against {ate_ref} m uncapped")
    check(restored_back > 0, "capped sweep: no restore on the return leg")
    check(launches == len(frames), f"capped sweep: {launches} launches for {len(frames)} frames")
    check(vector == launches, "capped sweep: did not take the column kernel")
    return launches, dict(gt=gt, frames=frames, cap=cap)


def slam_config(**posegraph):
    """The app's VGA operating point (``topfusion_tpu_torch.apps.run_fusion``,
    as apps/run_fusion.py:127-160): the ``--synthetic-vga`` camera (640x480,
    fx = fy = 500), the default ``PipelineConfig`` with 4096 visible blocks,
    the int16 pool, K = 96 surfels and the occlusion cull, and the default
    ``PoseGraphConfig`` (256 keyframes, 1024 edges, keyframes every 10
    frames at level 1, PCG 10 x 48, re-integration) with ``posegraph``
    replaced."""
    import argparse

    from topfusion_tpu_torch.apps.run_fusion import _app_config
    from topfusion_tpu_torch.config import CameraConfig

    cfg = _app_config(argparse.Namespace(config=None, overrides=[], rgb=False))
    return dataclasses.replace(
        cfg, camera=CameraConfig(width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0),
        posegraph=dataclasses.replace(cfg.posegraph, **posegraph))


def out_and_back(n: int, yaw: float = 0.08, shift: float = 0.10):
    """tests/test_slam.py's out-and-back: ``yaw`` rad (0.08) and ``shift`` m
    along x (0.10) at the turn, back to the start."""
    import math

    import torch

    from topfusion_tpu_torch.geometry.se3 import se3_exp

    return [se3_exp(torch.tensor([0, yaw * s, 0, shift * s, 0.02 * s, 0])).numpy()
            for s in (math.sin(math.pi * i / (n - 1)) for i in range(n))]


def run_slam(cfg, frames, device, count_syncs: bool = False, profile_chunk=None) -> dict:
    """The frames through ``SlamSystem.process_chunk`` in chunks of
    SLAM_CHUNK from a warmed system, the integrate launch counts set to 0
    just before and read just after.  Every re-integration is recorded
    with the frames it re-fuses (its keyframes, and the ring's frames),
    which is the launch count the code implies.  With ``count_syncs`` the
    host syncs of each chunk are counted (PyTorch's sync debug mode); the
    chunk numbered ``profile_chunk`` runs under the profiler."""
    import warnings

    import torch

    from topfusion_tpu_torch.models.slam import SlamSystem
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda

    slam = SlamSystem(cfg, device=device)
    slam.warmup(SLAM_CHUNK)
    refused = []
    reint = slam._reint

    def recorded_reint(*args):
        frame_now, num_kf = args[6], args[7]
        refused.append(num_kf + (frame_now - max(frame_now - slam.R, 0) if slam.R else 0))
        return reint(*args)

    slam._reint = recorded_reint
    r = dict(infos=[], chunk_ms=[], syncs=[], refused=refused)
    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = 0
    integrate_blocks_cuda.vector_launches = 0
    for c0 in range(0, len(frames), SLAM_CHUNK):
        chunk = frames[c0:c0 + SLAM_CHUNK]
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                if c0 // SLAM_CHUNK == profile_chunk:
                    got = []
                    r["profile"] = profiled(lambda: got.append(slam.process_chunk(chunk)))
                    infos = got[0]
                else:
                    infos = slam.process_chunk(chunk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        r["chunk_ms"].append((time.perf_counter() - t0) * 1000)
        r["syncs"].append(sum(str(w.message).startswith("called a synchronizing") for w in rec))
        r["infos"] += infos
    torch.cuda.synchronize()
    r["launches"] = integrate_blocks_cuda.launches
    r["vector_launches"] = integrate_blocks_cuda.vector_launches
    r["slam"] = slam
    return r


def check_slam(name, r, gt) -> tuple:
    """The assertions of phase 12 (a) and (b): every frame tracked, no
    reset, no block dropped, a loop closed, the optimized ATE under
    ATE_LIMIT_M and within 1.5 x the odometry's + 1 mm, and one column
    kernel launch per frame and per re-fused frame.  Returns (odometry
    ATE, optimized ATE)."""
    from topfusion_tpu_torch.io.trajectory import ate_rmse

    slam, infos = r["slam"], r["infos"]
    odom = ate_rmse(slam.odom_poses, gt, align=False)
    opt = ate_rmse(slam.optimized_trajectory(), gt, align=False)
    expect = len(infos) + sum(r["refused"])
    n_chunks = len(r["chunk_ms"])
    print(f"{name}: {len(infos)} frames in {n_chunks} chunks, {int(slam.graph.num_kf)} keyframes, "
          f"{int(slam.graph.num_edges)} edges, loops closed {slam.loops_closed}, "
          f"re-integrations {slam.reintegrations} (re-fusing {r['refused']} frames); ATE "
          f"odometry {odom * 1000:.3f} mm, optimized {opt * 1000:.3f} mm; kernel launches "
          f"{r['launches']} ({r['vector_launches']} of the column kernel), implied {expect}; "
          f"ms per chunk {[round(x, 1) for x in r['chunk_ms']]}, host syncs per chunk "
          f"{r['syncs']}")
    check(all(i["ok"] for i in infos), f"{name}: a frame failed to track")
    check(not any(i["reset"] for i in infos), f"{name}: the pipeline reset")
    check(all(i["dropped"] == 0 for i in infos), f"{name}: blocks dropped")
    check(slam.loops_closed >= 1, f"{name}: no loop closed")
    check(opt < ATE_LIMIT_M, f"{name}: optimized ATE {opt} m >= {ATE_LIMIT_M} m")
    check(opt <= 1.5 * odom + 1e-3, f"{name}: optimized ATE {opt} m against odometry {odom} m")
    check(r["launches"] == expect, f"{name}: {r['launches']} launches, the code implies {expect}")
    check(r["vector_launches"] == r["launches"], f"{name}: did not take the column kernel")
    return odom, opt


def slam_phase(device) -> tuple:
    """Phase 12.  Returns the kernel launches of (a) and (b), and (a)'s
    frames and results for phase 16."""
    import os

    import numpy as np
    import torch

    from topfusion_tpu_torch.io.gif import gif_frames
    from topfusion_tpu_torch.io.synthetic import SyntheticScene
    from topfusion_tpu_torch.models.posegraph import detect_loop
    from topfusion_tpu_torch.ops.tsdf_block import raycast_blocks

    cfg = slam_config()
    scene = SyntheticScene()
    for n in SLAM_FRAMES:
        gt = out_and_back(n)
        frames = torch.stack([scene.render_depth_mm(
            cfg.camera, torch.as_tensor(T, device=device)) for T in gt])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = run_slam(cfg, frames, device, count_syncs=True)
        peak = torch.cuda.max_memory_allocated()
        if a["slam"].loops_closed >= 1:
            break
        print(f"slam: the {n}-frame out-and-back closed no loop: a longer one")
    print(f"slam (a): out-and-back of {n} frames at {cfg.camera.width}x{cfg.camera.height}, "
          f"chunks of {SLAM_CHUNK}, graph {cfg.posegraph.max_keyframes} keyframes x "
          f"{cfg.posegraph.max_edges} edges, solver {cfg.posegraph.solver} "
          f"{cfg.posegraph.gn_iters} x {cfg.posegraph.cg_iters}; peak memory "
          f"{peak / 2**20:.1f} MiB")
    check_slam("slam (a)", a, gt)
    for k, (ms, syncs) in enumerate(zip(a["chunk_ms"], a["syncs"])):
        size = min(SLAM_CHUNK, n - k * SLAM_CHUNK)
        loop = any(i["loop"] for i in a["infos"][k * SLAM_CHUNK:(k + 1) * SLAM_CHUNK])
        if not loop:  # a closure adds the solve's fetch
            check(syncs <= size + 2, f"slam (a): chunk {k} of {size} frames synced {syncs} times")
    # What phase 16 (a) holds the sharded system to.
    slam_a = dict(gt=gt, frames=frames.cpu().numpy(), **slam_digest(a["slam"]),
                  launches=a["launches"], refused=list(a["refused"]), chunk_ms=a["chunk_ms"])
    del a["slam"]

    # (b): every correction rebuilds the map, from the keyframes and a ring.
    cfg_b = slam_config(min_map_correction=0.0, reint_ring=SLAM_RING)
    runs = []
    for k in range(2):
        b = run_slam(cfg_b, frames, device, profile_chunk=0 if k else None)
        slam = b["slam"]
        b["graph"] = [t.clone() for t in slam.graph]
        b["poses"] = np.stack(slam.odom_poses)
        b["opt"] = np.stack(slam.optimized_trajectory())
        runs.append(b)
    b = runs[0]
    slam = b["slam"]
    check_slam("slam (b)", b, gt)
    check(slam.reintegrations >= 1, "slam (b): no re-integration")
    b_launches = b["launches"]
    same = (all(torch.equal(x, y) for x, y in zip(runs[0]["graph"], runs[1]["graph"]))
            and np.array_equal(runs[0]["poses"], runs[1]["poses"])
            and np.array_equal(runs[0]["opt"], runs[1]["opt"]))
    print(f"  slam (b) twice: graphs, odometry and optimized poses bit-identical {same}")
    check(same, "slam (b): two runs differ")

    # The rebuilt map, raycast from the corrected live pose, against the
    # scene's depth at the matching optimized pose (as tests/test_slam.py).
    cam, voxel = cfg_b.camera, cfg_b.tsdf.voxel_size
    T_live = torch.as_tensor(b["opt"][-1], device=device)
    rc = raycast_blocks(slam.state.block_map(), cam, cfg_b.tsdf, cfg_b.blockmap, cfg_b.raycast,
                        slam.state.T_wc)
    d_scene = scene.render_depth(cam, T_live)
    both = (rc.depth > 0) & (d_scene > 0) & rc.hit
    med = float(torch.abs(rc.depth - d_scene)[both].median())
    print(f"  rebuilt map against the scene from the corrected pose: {float(both.float().mean()):.4f} "
          f"of the image compared, median |depth error| {med * 1000:.3f} mm ({med / voxel:.3f} voxels)")
    check(float(both.float().mean()) > 0.5, "slam (b): the rebuilt map covers too little")
    check(med < 3 * voxel, f"slam (b): median depth error {med} m >= 3 voxels")
    more = slam.process_chunk(frames[-SLAM_MORE:])
    check(all(i["ok"] for i in more), "slam (b): tracking lost after the rebuild")

    # What the pieces cost on the warm card, on the graph and map of (b).
    pgc = dataclasses.replace(cfg_b.posegraph, loop_queries=max(
        cfg_b.posegraph.loop_queries, SLAM_CHUNK // cfg_b.posegraph.keyframe_every))
    measure("detect_loop", lambda: detect_loop(slam.graph, slam.cam_l, pgc, cfg_b.icp), repeats=3)
    kidx = len(slam.kf_odom_poses) - 1
    measure("_optimize_ex", lambda: slam._optimize_ex(slam.graph, slam.kf_odom_buf[kidx]),
            repeats=3)
    measure("_reint", lambda: slam._reint(slam.state, slam.graph, slam.kf_depth_buf,
                                          slam.kf_odom_buf[kidx], slam.kf_odom_buf, slam._ring(),
                                          slam.frame_idx, len(slam.kf_odom_poses)), repeats=3)
    ops, device_ms, wall_ms, top = runs[1]["profile"]
    print(f"  (b)'s first chunk of {SLAM_CHUNK} frames, second run, under the profiler: "
          f"{ops} device operations, "
          f"{device_ms:.3f} ms of device time, wall {wall_ms:.1f} ms (with the profiler's cost); "
          f"top kernels: " + "; ".join(f"{us / 1000:.3f} ms {k[:60]}" for k, us in top.most_common(4)))
    del runs, slam, b

    # (c): the app, as a user runs it.
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "topfusion_tpu_torch.apps.run_fusion", "--synthetic",
               str(SLAM_APP_FRAMES), "--synthetic-vga", "--render-every", str(SLAM_CHUNK),
               "--video", "--orbit-video", str(APP_ORBIT_VIEWS), "--out", out]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=SLAM_APP_TIMEOUT_S,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        print(f"slam (c): {' '.join(cmd[1:4])} ... exited {res.returncode} in {secs:.1f} s")
        print("\n".join("  | " + line for line in res.stdout.strip().splitlines()[-6:]))
        check(res.returncode == 0, f"slam (c): the app failed:\n{res.stderr[-3000:]}")
        names = sorted(os.listdir(out))
        want = ["cloud.ply", "metrics.json", "metrics.jsonl", "render_final.png", "state.npz",
                "trajectory_odom.txt", "trajectory_opt.txt", "video.gif", "orbit.gif"]
        print(f"  files: {names}")
        check(all(f in names for f in want), f"slam (c): missing {set(want) - set(names)}")
        check(any(f.startswith("config.") for f in names), "slam (c): no config written")
        check(any(f.startswith("render_0") for f in names), "slam (c): no periodic render")
        with open(os.path.join(out, "metrics.json")) as f:
            summary = json.load(f)
        print(f"  app: ATE odometry {summary['ate_odom_m'] * 1000:.3f} mm, optimized "
              f"{summary['ate_opt_m'] * 1000:.3f} mm, {summary['app_fps_total']:.2f} frames/s "
              f"overall, loops {summary['loops_closed']}, device {summary['device']}")
        check(summary["ate_opt_m"] < ATE_LIMIT_M, f"slam (c): optimized ATE {summary['ate_opt_m']} m")
        # The GIFs: a half-size render per chunk (the chunk is SLAM_CHUNK,
        # the remainder goes a frame at a time), and the orbit at full size.
        w, h = cfg.camera.width, cfg.camera.height
        n_chunks = SLAM_APP_FRAMES // SLAM_CHUNK + SLAM_APP_FRAMES % SLAM_CHUNK
        video = gif_frames(os.path.join(out, "video.gif"))
        orbit = gif_frames(os.path.join(out, "orbit.gif"))
        print(f"  video.gif: {len(video)} images {sorted(set(video))} (width, height, delay "
              f"in 1/100 s), written in {summary['video_gif_s']:.3f} s; orbit.gif: {len(orbit)} "
              f"images {sorted(set(orbit))}, rendered in {summary['orbit_render_s']:.3f} s and "
              f"written in {summary['orbit_gif_s']:.3f} s, mean coverage "
              f"{summary['orbit_coverage']:.4f}")
        check(video == [(-(-w // 2), -(-h // 2), 20)] * n_chunks,
              f"slam (c): video.gif holds {video}, not {n_chunks} half-size images")
        check(orbit == [(w, h, 10)] * APP_ORBIT_VIEWS,
              f"slam (c): orbit.gif holds {orbit}, not {APP_ORBIT_VIEWS} full-size images")
        check(summary["orbit_coverage"] > 0, "slam (c): the orbit renders show nothing")
    return {"slam": a["launches"], "slam_reintegrate": b_launches}, slam_a


def slam_digest(slam) -> dict:
    """What two SLAM runs must share to be the same run: the odometry and
    optimized trajectories, the graph's and the map's bits, the counters."""
    import numpy as np

    return dict(odom=np.stack(slam.odom_poses), opt=np.stack(slam.optimized_trajectory()),
                graph=state_digest(slam.graph), state=state_digest(slam.state),
                loops=slam.loops_closed, reint=slam.reintegrations,
                num_kf=int(slam.graph.num_kf), num_edges=int(slam.graph.num_edges))


def count_syncs(fn):
    """(fn(), the host syncs PyTorch's sync debug mode detected in it)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(str(w.message).startswith("called a synchronizing") for w in rec)


def max_pose_diff(a, b) -> tuple:
    """The largest translation (m) and rotation (degrees, from the skew
    part of Ra^T Rb) between two lists of poses on the card."""
    import math

    import torch

    dt = dr = 0.0
    for Ta, Tb in zip(a, b):
        dt = max(dt, float((Ta[:3, 3] - Tb[:3, 3]).abs().max()))
        M = Ta[:3, :3].double().T @ Tb[:3, :3].double()
        w = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
        dr = max(dr, math.degrees(math.asin(min(float(w.norm()) / 2.0, 1.0))))
    return dt, dr


def association_audit(pipe, frames) -> dict:
    """One pass of the onehot pipeline over the frames with every nearest
    association made twice at the same inputs, onehot and flat (the only
    difference between them is the band): how many there were, how many
    lost correspondences to the band and how many, how many gave a G that
    is not bit-equal to flat's, and how many counted more than flat's.  It syncs the host per association
    (a diagnostic pass, not the measured one)."""
    import torch

    from topfusion_tpu_torch.ops import icp as ticp

    orig = ticp.build_normal_equations
    a = {"associations": 0, "with drops": 0, "dropped": 0, "most dropped": 0,
         "flat count there": 0, "G differs": 0, "more than flat": 0, "first frame": None,
         "first iteration": None}
    where = {"frame": 0, "iteration": 0}

    def both(*args, **kw):
        G, n = orig(*args, **kw)
        if not kw["bilinear"]:
            G_f, n_f = orig(*args, **{**kw, "gather_mode": "flat"})
            d = int(n_f) - int(n)
            a["associations"] += 1
            a["dropped"] += d
            differs = not torch.equal(G, G_f)
            a["G differs"] += differs
            a["more than flat"] += d < 0
            if differs and a["first frame"] is None:
                a["first frame"], a["first iteration"] = where["frame"], where["iteration"]
            if d > 0:
                a["with drops"] += 1
                if d > a["most dropped"]:
                    a["most dropped"], a["flat count there"] = d, int(n_f)
        where["iteration"] += 1
        return G, n

    ticp.build_normal_equations = both
    try:
        state = pipe.init()
        for i, f in enumerate(frames):
            where.update(frame=i, iteration=0)
            state, _ = pipe.step(state, f)
    finally:
        ticp.build_normal_equations = orig
    return a


def onehot_phase(frames, poses, flat_est, flat_profile, device) -> int:
    """Phase 13: the orbit through ICP's onehot gather mode.  Returns the
    kernel launches of the run."""
    import torch

    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline

    cfg = bench_config("int16")
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, gather_mode="onehot"))
    icp = cfg.icp
    pipe = BlockPipeline(cfg, device)
    state, est, auxes, launches, vector_launches = counted_run(pipe, frames)
    check_tracked("ICP one-hot", frames, poses, state, est, auxes, launches, vector_launches)
    dt, dr = max_pose_diff(est, flat_est)
    same = all(torch.equal(a, b) for a, b in zip(est, flat_est))

    # The same orbit in the take mode: its bilinear (polish) iterations go
    # through the same take quad as the onehot mode's, its nearest ones
    # read the same elements as flat's.
    take = BlockPipeline(dataclasses.replace(
        cfg, icp=dataclasses.replace(icp, gather_mode="take")), device)
    _, take_est, _ = run(take, take.init(), frames)
    take_is_flat = all(torch.equal(a, b) for a, b in zip(take_est, flat_est))
    take_is_onehot = all(torch.equal(a, b) for a, b in zip(take_est, est))
    dt_take, dr_take = max_pose_diff(take_est, flat_est)

    audit = association_audit(pipe, frames)

    (_, aux), syncs = count_syncs(lambda: pipe.step(state, frames[-1]))
    ms, ops, device_ms, peak = timed_passes(pipe, state, frames, 1)
    flat_ops, flat_device_ms = flat_profile
    print(f"  every nearest association of a pass (margin {icp.onehot_v_margin}) also made flat at "
          f"the same inputs: {audit['associations']} associations, {audit['with drops']} with "
          f"correspondences dropped by the band ({audit['dropped']} in all, at most "
          f"{audit['most dropped']} of {audit['flat count there']} in one), "
          f"{audit['G differs']} with G not bit-equal to flat's (the first at frame "
          f"{audit['first frame']}, iteration {audit['first iteration']} of the frame's ICP)")
    print(f"  poses against the flat run of phase 4: bit-identical {same}, largest difference "
          f"{dt * 1000:.6f} mm and {dr:.6f} degrees; the take-mode run against it: bit-identical "
          f"{take_is_flat}, {dt_take * 1000:.6f} mm and {dr_take:.6f} degrees; onehot against "
          f"take: bit-identical {take_is_onehot}; host syncs in one step {syncs}")
    print(f"  onehot step: {ms:.2f} ms/frame ({1000 / ms:.2f} frames/s) over 1 pass; profiled pass: "
          f"{ops:.1f} device ops/frame, device time {device_ms:.3f} ms/frame (flat, phase 5: "
          f"{flat_ops:.1f} and {fmt_ms(flat_device_ms)}); peak memory {peak / 2**20:.1f} MiB")
    check(audit["associations"] == len(frames) * (sum(icp.iters) - icp.bilinear_polish_iters),
          f"ICP one-hot: {audit['associations']} nearest associations audited")
    check(audit["more than flat"] == 0, "ICP one-hot: the band admitted what flat rejects")
    check(syncs == 1 and bool(aux.ok), f"ICP one-hot: a step synced the host {syncs} times")
    return launches


def negative_fy_phase(poses, flat_est, device) -> int:
    """Phase 14: the bench configuration with fy negated (the ICL-NUIM
    convention), the scene rendered through that camera.  Returns the
    kernel launches of the run."""
    import torch

    from topfusion_tpu_torch.io.trajectory import ate_rmse
    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.ops.tsdf_block import integrate_blocks

    cfg = bench_config("int16")
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, fy=-cfg.camera.fy))
    cam, tc, bm = cfg.camera, cfg.tsdf, cfg.blockmap
    frames = render_frames(cfg, poses, device)

    m, T, raw, vis = integrate_inputs(cfg, frames, poses, device)
    before = integrate_blocks_cuda.vector_launches
    mk, nk = integrate_blocks_cuda(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()),
                                   cam, tc, bm, T, raw, vis)
    mp, np_ = integrate_blocks(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()),
                               cam, tc, bm, T, raw, vis)
    torch.cuda.synchronize()
    updated = int((mp.weight != m.weight).sum())
    equal = torch.equal(mk.tsdf, mp.tsdf) and torch.equal(mk.weight, mp.weight)
    print(f"fy = {cam.fy}: integrate, num_visible kernel {int(nk)} plain {int(np_)}, {updated} "
          f"voxels updated, pool bit-equal {equal}")
    check(integrate_blocks_cuda.vector_launches == before + 1, "fy < 0: the column kernel was not launched")
    check(int(nk) == int(np_) > 1000 and updated > 0, "fy < 0: trivial comparison")
    check(equal, "fy < 0: kernel and plain pools differ")

    pipe = BlockPipeline(cfg, device)
    state, est, auxes, launches, vector_launches = counted_run(pipe, frames)
    ate_neg = check_tracked("fy < 0 orbit", frames, poses, state, est, auxes, launches,
                            vector_launches)
    ate_pos = ate_rmse([T.cpu().numpy() for T in flat_est], poses, align=False)
    print(f"  ATE fy < 0 {ate_neg * 1000:.3f} mm against fy > 0 (phase 4) {ate_pos * 1000:.3f} mm; "
          f"limit 1.3 x {ate_pos * 1000:.3f} + 0.1 mm")
    check(ate_neg < 1.3 * ate_pos + 1e-4, f"fy < 0: ATE {ate_neg} m against {ate_pos} m at fy > 0")
    return launches


SHARDS = 4  # the gloo world of phase 15 (b) and (c), sharing the one card
# Phase 15 (c) sweeps the first SHARDED_SWEEP_FWD frames of phase 11's
# corridor out and back (phase 11's 40 + 39 took 53 s there with the
# uncapped run; 32 out still map more than 1.2 x phase 11's capacity).
SHARDED_SWEEP_FWD = 32


def state_digest(state) -> dict:
    """sha256 of every tensor of a block state, by field (model maps by
    level), to compare states across processes to the bit."""
    import hashlib

    import torch

    out = {}
    for name, v in state._asdict().items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            out[f"{name}[{i}]" if isinstance(v, tuple) else name] = hashlib.sha256(
                raw.tobytes()).hexdigest()
    return out


def sharded_orbit(axis, poses, frames_np) -> dict:
    """Phase 15 (a) and (b) on one shard: the orbit through
    ``ShardedBlockPipeline`` at the bench configuration from a fresh state,
    with the integrate kernel's launch counts set to 0 just before and
    read just after; then one timed pass, one profiled pass (in a world
    of one: where four processes time-slice one card, a shard's device
    time has no clear meaning) and one step under the sync counter from
    the fused state; the integrate kernel
    against its plain version on this shard's local pool; and the
    composited render.  Returns what the parent checks and prints."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.ops.blockmap import EMPTY_KEY
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.ops.depth import depth_to_meters
    from topfusion_tpu_torch.ops.tsdf_block import integrate_blocks, visible_blocks
    from topfusion_tpu_torch.parallel import ShardedBlockPipeline
    from topfusion_tpu_torch.utils.device_info import mesh_banner

    clock = [time.perf_counter()]
    seconds = {}

    def lap(what):
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        seconds[what] = clock[-1] - clock[-2]

    dev = axis.device
    banner = mesh_banner(axis)
    cfg = bench_config("int16")
    frames = [torch.from_numpy(f).to(dev) for f in frames_np]
    pipe = ShardedBlockPipeline(cfg, axis, dev)
    n = len(frames)
    lap("setup")

    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = 0
    integrate_blocks_cuda.vector_launches = 0
    calls0, bytes0 = axis.calls, axis.bytes
    state, est, auxes = run(pipe, pipe.init(), frames)
    torch.cuda.synchronize()
    launches, vector = integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches
    calls, nbytes = (axis.calls - calls0) / n, (axis.bytes - bytes0) / n
    out = dict(
        rank=axis.rank, banner=banner, launches=launches, vector=vector,
        calls_per_frame=calls, bytes_per_frame=nbytes,
        poses=[T.cpu().numpy() for T in est],
        ok=[bool(a.ok) for a in auxes], resets=int(state.resets),
        dropped=sum(int(a.blocks_dropped) for a in auxes),
        num_blocks=int(auxes[-1].num_blocks), local_blocks=int(state.num_blocks),
        digest=state_digest(state),
        keys=state.bucket_keys[state.bucket_keys != EMPTY_KEY].cpu().numpy(),
        finite=all(bool(torch.isfinite(p).all()) for p in state.model_points),
    )

    lap("counted run")
    fused = state
    run(pipe, fused, frames)
    lap("timed pass")
    out["ms_per_frame"] = seconds["timed pass"] * 1000 / n
    out["ops_per_frame"] = out["device_ms_per_frame"] = None
    if axis.size == 1:
        ops, device_ms, _, _ = profiled(lambda: run(pipe, fused, frames))
        out["ops_per_frame"], out["device_ms_per_frame"] = ops / n, (device_ms / n if device_ms else None)
    _, out["syncs_per_step"] = count_syncs(lambda: pipe.step(fused, frames[-1]))
    lap("profiled pass and sync count" if axis.size == 1 else "sync count")

    # The kernel against its plain version on this shard's local pool, at
    # the last frame's pose and depth (not counted: the main path's run is over).
    lc = pipe.local_cfg
    T = fused.T_wc
    raw = depth_to_meters(frames[-1], cfg.preproc.max_sensor_depth)
    m = fused.block_map()
    vis = visible_blocks(m, lc.camera, lc.tsdf, lc.blockmap, T, depth=raw)
    args = (lc.camera, lc.tsdf, lc.blockmap, T, raw, vis)
    k, nk = integrate_blocks_cuda(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    p, np_ = integrate_blocks(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    torch.cuda.synchronize()
    out["kernel_equal"] = (torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)
                           and int(nk) == int(np_))
    out["kernel_visible"] = int(nk)
    out["kernel_max_abs_err"] = float((k.tsdf.float() - p.tsdf.float()).abs().max())
    lap("kernel against plain")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pipe.render(fused)
    torch.cuda.synchronize()
    out["render_ms"] = (time.perf_counter() - t0) * 1000
    out["render"] = img.cpu().numpy()
    lap("render")
    if axis.size == 1:
        # The single-device march with the same gate, shaded: the render
        # of one shard must be it, bit for bit; and its depth against the
        # scene's exact depth.
        from topfusion_tpu_torch.io.synthetic import SyntheticScene
        from topfusion_tpu_torch.models.block_pipeline import BlockPipeline, shade
        from topfusion_tpu_torch.ops.tsdf_block import raycast_blocks

        rc = raycast_blocks(m, lc.camera, lc.tsdf, lc.blockmap, lc.raycast, T,
                            weight_gate="nearest")
        out["render_is_single_device_march"] = torch.equal(img, shade(rc.points, rc.normals, T))
        gt = SyntheticScene().render_depth(lc.camera, T)
        mask = rc.hit & (gt > 0) & (gt < 1.5)
        out["raycast_cover"] = float(mask.float().mean())
        out["raycast_median_err"] = float(torch.abs(rc.depth - gt)[mask].median())
        out["block_render"] = BlockPipeline(cfg, dev).render(fused).cpu().numpy()
    out["seconds"] = {k: round(v, 2) for k, v in seconds.items()}
    return out


def sharded_sweep(axis, frames_np, cap: int, evict: int, restore: int) -> dict:
    """Phase 15 (c) on one shard: the corridor sweep of phase 11 through
    ``ShardedBlockPipeline``, uncapped (2^16 blocks over the shards) and
    then with ``cap`` blocks over the shards and a ``ShardedHostCache``
    per shard, the kernel's launches counted over the capped run."""
    import torch

    from topfusion_tpu_torch.models.host_cache import ShardedHostCache
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.parallel import ShardedBlockPipeline

    dev = axis.device
    frames = [torch.from_numpy(f).to(dev) for f in frames_np]
    out = {}
    for name, capacity in (("uncapped", 1 << 16), ("capped", cap)):
        pipe = ShardedBlockPipeline(sweep_config(capacity), axis, dev)
        cache = (ShardedHostCache(pipe, evict_batch=evict, restore_batch=restore)
                 if name == "capped" else None)
        state = pipe.init()
        poses, auxes, restored, evicted = [], [], [], []
        torch.cuda.synchronize()
        integrate_blocks_cuda.launches = 0
        integrate_blocks_cuda.vector_launches = 0
        t0 = time.perf_counter()
        for f in frames:
            if cache is not None:
                n0 = cache.n_host_blocks
                T_pred = poses[-1] if poses else state.T_wc.cpu().numpy()
                state = cache.before_step(state, T_pred)
                restored.append(n0 - cache.n_host_blocks)
            state, aux = pipe.step(state, f)
            poses.append(state.T_wc.cpu().numpy())
            auxes.append(aux)
            if cache is not None:
                n0 = cache.n_host_blocks
                state = cache.after_step(state)
                evicted.append(cache.n_host_blocks - n0)
        torch.cuda.synchronize()
        out[name] = dict(
            seconds=time.perf_counter() - t0, poses=poses,
            ok=[bool(a.ok) for a in auxes], resets=int(state.resets),
            dropped=sum(int(a.blocks_dropped) for a in auxes),
            total=int(auxes[-1].num_blocks), live=int(state.num_blocks),
            launches=integrate_blocks_cuda.launches, vector=integrate_blocks_cuda.vector_launches,
            host=cache.n_host_blocks if cache else 0, restored=restored, evicted=evicted,
        )
    return out


def world4_body(axis, poses, frames_np, sweep_np, cap, evict, restore) -> dict:
    """Phase 15 (b) and then (c), in one world of ``SHARDS`` gloo processes."""
    return dict(orbit=sharded_orbit(axis, poses, frames_np),
                sweep=sharded_sweep(axis, sweep_np, cap, evict, restore))


def sharded_phase(poses, frames, phase4, sweep) -> dict:
    """Phase 15.  ``phase4``: the main path's trajectory, state digest,
    block count and profiled (operations, device ms) per frame;
    ``sweep``: phase 11's ground truth, frames and capped capacity.
    Returns the kernel launches of the sharded paths."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.io.trajectory import ate_rmse
    from topfusion_tpu_torch.parallel import spawn_world

    frames_np = [f.cpu().numpy() for f in frames]
    n = len(frames)

    def report(tag, o):
        dm, ops = o["device_ms_per_frame"], o["ops_per_frame"]
        print(f"  {tag}: {o['ms_per_frame']:.2f} ms/frame, device ops/frame "
              f"{'not measured' if ops is None else f'{ops:.1f}'}, "
              f"device time {'not measured' if dm is None else f'{dm:.3f} ms/frame'}, "
              f"{o['calls_per_frame']:.1f} collective calls and {o['bytes_per_frame']:.0f} B/frame, "
              f"{o['syncs_per_step']} host syncs per step, "
              f"render {o['render_ms']:.2f} ms; kernel launches {o['launches']} "
              f"({o['vector']} of the column kernel); local blocks {o['local_blocks']}; kernel "
              f"vs plain on the local pool over {o['kernel_visible']} visible entries: "
              f"{'bit-equal' if o['kernel_equal'] else 'DIFFERENT'}; seconds {o['seconds']}")

    # (a) A world of one NCCL process: the single-device step, bit for bit.
    t0 = time.perf_counter()
    (a,) = spawn_world(sharded_orbit, 1, "nccl", "cuda", args=(poses, frames_np), timeout_s=600)
    print(f"15 (a), world of 1 ({time.perf_counter() - t0:.1f} s with the spawn): {a['banner']}")
    report("rank 0", a)
    ate = ate_rmse(a["poses"], poses, align=False)
    same_poses = all(np.array_equal(x, y) for x, y in zip(a["poses"], phase4["poses"]))
    diff = sorted(k for k in phase4["digest"] if a["digest"][k] != phase4["digest"][k])
    print(f"  ATE {ate * 1000:.3f} mm; against phase 4: trajectory bit-identical {same_poses}, "
          f"state fields that differ: {diff or 'none'}")
    check(all(a["ok"]) and a["resets"] == 0, "15 (a): a frame failed to track")
    check(same_poses, "15 (a): the trajectory differs from phase 4's")
    check(not diff, f"15 (a): the state differs from phase 4's in {diff}")
    check(a["launches"] == n and a["vector"] == n, f"15 (a): {a['launches']} launches for {n} frames")
    check(a["kernel_equal"], "15 (a): kernel and plain differ on the local pool")
    img, ref = a["render"].astype(np.int32), a["block_render"].astype(np.int32)
    same = float((img == ref).all(axis=-1).mean())
    close = float((np.abs(img - ref) <= 1).all(axis=-1).mean())
    print(f"  sharded render (full march, nearest-voxel weight gate): the single-device march "
          f"with that gate, shaded, bit for bit {a['render_is_single_device_march']}; against "
          f"BlockPipeline.render (ranged march, trilinear gate) {same:.5f} of the pixels equal, "
          f"{close:.5f} within one grey level; the march covers {a['raycast_cover']:.4f} of the "
          f"image against the exact depth, median |error| {a['raycast_median_err'] * 1000:.3f} mm")
    check(a["render_is_single_device_march"], "15 (a): the render is not the single-device march")
    voxel = bench_config().tsdf.voxel_size
    check(a["raycast_cover"] > 0.3, "15 (a): the sharded raycast covers too little")
    check(a["raycast_median_err"] < 2 * voxel, "15 (a): sharded raycast depth error >= 2 voxels")

    # (b) and (c): a world of SHARDS gloo processes sharing the card.
    # Phase 11's sweep is out and back: out index i is at position i.
    legs = list(range(SHARDED_SWEEP_FWD)) + list(range(SHARDED_SWEEP_FWD - 2, -1, -1))
    gt_sw = [sweep["gt"][i] for i in legs]
    frames_sw, cap = [sweep["frames"][i] for i in legs], sweep["cap"]
    evict, restore = SWEEP_EVICT_BATCH // SHARDS, SWEEP_RESTORE_BATCH // SHARDS
    t0 = time.perf_counter()
    ranks = spawn_world(world4_body, SHARDS, "gloo", "cuda", timeout_s=900,
                        args=(poses, frames_np, [f.cpu().numpy() for f in frames_sw], cap,
                              evict, restore))
    print(f"15 (b), world of {SHARDS} ({time.perf_counter() - t0:.1f} s with (c) and the spawn): "
          f"{ranks[0]['orbit']['banner']}")
    orbit = [r["orbit"] for r in ranks]
    for o in orbit:
        report(f"rank {o['rank']}", o)
    ate4 = ate_rmse(orbit[0]["poses"], poses, align=False)
    dt, dr = max_pose_diff([torch.as_tensor(T) for T in orbit[0]["poses"]],
                           [torch.as_tensor(T) for T in phase4["poses"]])
    keys = np.concatenate([o["keys"] for o in orbit])
    total = orbit[0]["num_blocks"]
    same_maps = all(o["digest"][k] == orbit[0]["digest"][k] for o in orbit
                    for k in o["digest"] if k.startswith("model_"))
    img = orbit[0]["render"]
    lit = float((img[..., 0] == img[..., 2]).mean())
    print(f"  ATE {ate4 * 1000:.3f} mm; poses against phase 4: at most {dt * 1000:.4f} mm and "
          f"{dr:.5f} degrees; blocks {total} over the shards ({sum(o['local_blocks'] for o in orbit)} "
          f"local, {len(np.unique(keys))} unique keys) against {phase4['num_blocks']} in phase 4; "
          f"model maps bit-identical over the shards {same_maps}; render lit share {lit:.4f}")
    for o in orbit:
        check(all(o["ok"]) and o["resets"] == 0, f"15 (b): rank {o['rank']} failed to track")
        check(o["launches"] == n and o["vector"] == n,
              f"15 (b): rank {o['rank']}: {o['launches']} launches for {n} frames")
        check(o["kernel_equal"], f"15 (b): rank {o['rank']}: kernel and plain differ")
        check(o["finite"], f"15 (b): rank {o['rank']}: non-finite model map")
        check(all(np.array_equal(x, y) for x, y in zip(o["poses"], orbit[0]["poses"])),
              f"15 (b): rank {o['rank']}'s poses differ from rank 0's")
        check(np.array_equal(o["render"], img), f"15 (b): rank {o['rank']}'s render differs")
    check(ate4 < ATE_LIMIT_M, f"15 (b): ATE {ate4} m")
    check(dt < 1e-3 and np.abs(np.stack(orbit[0]["poses"])[:, :3, :3]
                               - np.stack(phase4["poses"])[:, :3, :3]).max() < 1e-2,
          "15 (b): poses beyond 1 mm / 1e-2 of phase 4's")
    check(same_maps, "15 (b): the shards' model maps differ")
    check(len(np.unique(keys)) == len(keys) == total, "15 (b): a block is on two shards")
    check(abs(total - phase4["num_blocks"]) <= 0.05 * phase4["num_blocks"],
          f"15 (b): {total} blocks against {phase4['num_blocks']} in phase 4")
    check(0.3 < lit <= 1.0 and img.std() > 1.0, "15 (b): the composited render is trivial")

    # (c) The out-of-core sweep of phase 11 on the world of SHARDS.
    sw = [r["sweep"] for r in ranks]
    un, cp = [s["uncapped"] for s in sw], [s["capped"] for s in sw]
    total_sw = un[0]["total"]
    ate_ref = ate_rmse(un[0]["poses"], gt_sw, align=False)
    ate_cap = ate_rmse(cp[0]["poses"], gt_sw, align=False)
    host = sum(c["host"] for c in cp)
    live = sum(c["live"] for c in cp)
    n_sw = len(frames_sw)
    back = sum(sum(c["restored"][SHARDED_SWEEP_FWD:]) for c in cp)
    print(f"15 (c), sweep of {SHARDED_SWEEP_FWD} frames out and {n_sw - SHARDED_SWEEP_FWD} back "
          f"(phase 11's first {SHARDED_SWEEP_FWD}): uncapped N = {total_sw} blocks over the shards, ATE "
          f"{ate_ref * 1000:.3f} mm, {n_sw / un[0]['seconds']:.2f} frames/s; capped at {cap} "
          f"({cap // SHARDS} a shard, evict {evict}, restore {restore}): ATE {ate_cap * 1000:.3f} mm, "
          f"dropped {cp[0]['dropped']}, live {live} + host {host} = {live + host}, "
          f"{sum(sum(c['evicted']) for c in cp)} evicted, {sum(sum(c['restored']) for c in cp)} "
          f"restored ({back} on the return leg), {n_sw / cp[0]['seconds']:.2f} frames/s; launches "
          f"per rank {[c['launches'] for c in cp]}")
    for s in un + cp:
        check(all(s["ok"]) and s["resets"] == 0, "15 (c): a frame failed to track")
    check(total_sw > 1.2 * cap, f"15 (c): premise: {total_sw} blocks <= 1.2 x {cap}")
    check(cp[0]["dropped"] == 0, f"15 (c): {cp[0]['dropped']} blocks dropped despite swapping")
    check(host > 0 and back > 0, "15 (c): nothing went to the host or came back")
    check(live + host >= int(0.95 * total_sw), f"15 (c): live + host {live + host} < 0.95 N")
    check(ate_cap <= 1.2 * ate_ref + 2e-4, f"15 (c): ATE {ate_cap} m against {ate_ref} m uncapped")
    check(all(c["launches"] == n_sw and c["vector"] == n_sw for c in cp),
          "15 (c): not one column-kernel launch per frame on every shard")
    return {"step_sharded_world1": a["launches"],
            "step_sharded_world4": sum(o["launches"] for o in orbit),
            "step_sharded_sweep_world4": sum(c["launches"] for c in cp)}



# Phase 16 (b): a world of SHARDS gloo processes sharing the card runs the
# SLAM system over a wider out-and-back than phase 12's (SHARDED_SLAM_YAW
# rad and SHARDED_SLAM_SHIFT m at the turn, SHARDED_SLAM_FRAMES frames) in
# chunks of SHARDED_SLAM_CHUNK, every correction rebuilding the map from a
# ring of SHARDED_SLAM_CHUNK frames, with a ShardedHostCache per shard that
# keeps half of each shard's pool free (headroom), so that at most
# SHARDS x (capacity / 2) blocks stay live: fewer than the run maps.  The
# pool itself holds the rebuild, which re-fuses the keyframes and the ring
# with no swap (in both packages) and so must fit the pool.
SHARDED_SLAM_FRAMES = 60
SHARDED_SLAM_YAW, SHARDED_SLAM_SHIFT = 0.2, 0.25
SHARDED_SLAM_CHUNK = 10
SHARDED_SLAM_CAP = 1 << 13
SHARDED_SLAM_EVICT, SHARDED_SLAM_RESTORE = 256, 128  # per shard
SLAM_SAVE_AT = 2  # 16 (c): chunks before the checkpoint; the resumed run has the closure
SCALING_FRAMES = 2  # frames per pass of measure_scaling(_block) (16 (e))


def sharded_slam_config():
    """Phase 16 (b)'s configuration: the app's VGA operating point
    (``slam_config``) with a ring of SHARDED_SLAM_CHUNK frames, every
    correction rebuilding the map, and a pool of SHARDED_SLAM_CAP blocks
    over the shards with the out-of-core cache on."""
    cfg = slam_config(min_map_correction=0.0, reint_ring=SHARDED_SLAM_CHUNK)
    return dataclasses.replace(cfg, blockmap=dataclasses.replace(
        cfg.blockmap, capacity=SHARDED_SLAM_CAP, out_of_core=True))


def kernel_on_local_pool(state, cfg, depth_mm) -> dict:
    """The integrate kernel against its plain version on a shard's local
    pool, at the state's pose and ``depth_mm`` (not counted: the main
    path's run is over)."""
    import torch

    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.ops.depth import depth_to_meters
    from topfusion_tpu_torch.ops.tsdf_block import integrate_blocks, visible_blocks

    launches = integrate_blocks_cuda.launches
    raw = depth_to_meters(depth_mm, cfg.preproc.max_sensor_depth)
    m, T = state.block_map(), state.T_wc
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T, depth=raw)
    args = (cfg.camera, cfg.tsdf, cfg.blockmap, T, raw, vis)
    k, nk = integrate_blocks_cuda(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    p, np_ = integrate_blocks(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = launches
    return dict(equal=torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)
                and int(nk) == int(np_), visible=int(nk),
                max_abs_err=float((k.tsdf.float() - p.tsdf.float()).abs().max()))


def drive_sharded_slam(slam, frames, chunk: int, count: bool = False, save=None) -> dict:
    """Phase 16's main path on one shard: ``frames`` (a tensor on the
    card) through ``slam.process_chunk`` in chunks of ``chunk`` from a
    warmed system, the integrate kernel's launch count set to 0 just
    before and read just after.  Per chunk: ms (host clock; the chunk's
    fetch syncs), collective calls and bytes, and with ``count`` the host
    syncs (sync debug mode).  Every solve's collectives and every
    re-integration's re-fused frames, and every ``remap_store``'s counts,
    are recorded.  ``save = (after_chunks, path)`` saves the composed
    checkpoint after that chunk (outside the chunk's timing)."""
    import warnings

    import torch

    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda

    axis = slam.axis
    r = dict(infos=[], chunk_ms=[], syncs=[], calls=[], bytes=[], solves=[], refused=[], remaps=[],
             host=[])
    reint, solve = slam._reint, slam._optimize_ex

    def recorded_reint(*args):
        frame_now, num_kf = args[6], args[7]
        r["refused"].append(num_kf + (frame_now - max(frame_now - slam.R, 0) if slam.R else 0))
        return reint(*args)

    def recorded_solve(*args):
        c0, b0 = axis.calls, axis.bytes
        out = solve(*args)
        r["solves"].append((axis.calls - c0, axis.bytes - b0))
        return out

    slam._reint, slam._optimize_ex = recorded_reint, recorded_solve
    if slam.swap is not None:
        remap = slam.swap.remap_store

        def recorded_remap(corr):
            import numpy as np

            host = slam.swap.n_host_blocks
            stats = remap(corr)
            cos = np.clip((np.trace(corr[:3, :3]) - 1) / 2, -1.0, 1.0)
            r["remaps"].append(dict(stats, host_before=host, host_after=slam.swap.n_host_blocks,
                                    shift_mm=round(float(np.linalg.norm(corr[:3, 3])) * 1000, 3),
                                    angle_deg=round(float(np.degrees(np.arccos(cos))), 4)))
            return stats

        slam.swap.remap_store = recorded_remap
    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = 0
    integrate_blocks_cuda.vector_launches = 0
    for c0 in range(0, len(frames), chunk):
        part = frames[c0:c0 + chunk]
        calls0, bytes0 = axis.calls, axis.bytes
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if count:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                infos = slam.process_chunk(part)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        r["chunk_ms"].append((time.perf_counter() - t0) * 1000)
        r["syncs"].append(sum(str(w.message).startswith("called a synchronizing") for w in rec))
        r["calls"].append(axis.calls - calls0)
        r["bytes"].append(axis.bytes - bytes0)
        r["infos"] += infos
        r["host"].append(slam.swap.n_host_blocks if slam.swap is not None else 0)
        if save is not None and c0 // chunk + 1 == save[0]:
            t1 = time.perf_counter()
            slam.save_checkpoint(save[1])
            r["save_ms"] = (time.perf_counter() - t1) * 1000
    torch.cuda.synchronize()
    r["launches"] = integrate_blocks_cuda.launches
    r["vector_launches"] = integrate_blocks_cuda.vector_launches
    slam._reint, slam._optimize_ex = reint, solve
    return r


def sharded_dense(axis, orbit_np) -> dict:
    """Phase 16 (d) on one shard: the orbit through the sharded dense
    pipeline at phase 10's full-march configuration, then a timed pass."""
    import torch

    from topfusion_tpu_torch.parallel import make_sharded_pipeline

    frames = [torch.from_numpy(f).to(axis.device) for f in orbit_np]
    init, step = make_sharded_pipeline(dense_config(), axis)
    calls0, bytes0 = axis.calls, axis.bytes
    state, est, oks = init(), [], []
    for f in frames:
        state, aux = step(state, f)
        est.append(state.T_wc)
        oks.append(aux.ok)
    torch.cuda.synchronize()
    n = len(frames)
    out = dict(poses=[T.cpu().numpy() for T in est], ok=[bool(x) for x in oks],
               calls=(axis.calls - calls0) / n, bytes=(axis.bytes - bytes0) / n,
               digest=state_digest(state))
    t0 = time.perf_counter()
    for f in frames:
        state, _ = step(state, f)
    torch.cuda.synchronize()
    out["ms_per_frame"] = (time.perf_counter() - t0) * 1000 / n
    return out


def world1_body(axis, frames_np, orbit_np, ckpt) -> dict:
    """Phase 16 (a), (c) and the world of 1 of (d), in one NCCL process."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.parallel import ShardedSlamSystem
    from topfusion_tpu_torch.parallel.multihost import run_block_pipeline_demo
    from topfusion_tpu_torch.utils.device_info import mesh_banner

    dev = axis.device
    cfg = slam_config()
    frames = torch.from_numpy(frames_np).to(dev)
    slam = ShardedSlamSystem(cfg, axis)
    slam.warmup(SLAM_CHUNK)
    save_at = SLAM_SAVE_AT
    a = drive_sharded_slam(slam, frames, SLAM_CHUNK, count=True, save=(save_at, ckpt))
    a.update(slam_digest(slam), banner=mesh_banner(axis))
    a["kernel"] = kernel_on_local_pool(slam.state, slam.pipe.local_cfg, frames[-1])
    kidx = len(slam.kf_odom_poses) - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam._optimize_ex(slam.graph, slam.kf_odom_buf[kidx])
    torch.cuda.synchronize()
    a["solve_ms"] = (time.perf_counter() - t0) * 1000

    # (c) A fresh system restored from the checkpoint after SLAM_SAVE_AT
    # chunks runs the remaining ones: bit-identical to the run above.
    t0 = time.perf_counter()
    res = ShardedSlamSystem(cfg, axis)
    res.restore_checkpoint(ckpt)
    restore_ms = (time.perf_counter() - t0) * 1000
    at = res.frame_idx
    for c0 in range(at, len(frames), SLAM_CHUNK):
        res.process_chunk(frames[c0:c0 + SLAM_CHUNK])
    dres = slam_digest(res)
    same = (np.array_equal(dres["odom"], a["odom"]) and np.array_equal(dres["opt"], a["opt"])
            and dres["graph"] == a["graph"] and dres["state"] == a["state"]
            and (dres["loops"], dres["reint"]) == (a["loops"], a["reint"]))
    t0 = time.perf_counter()
    demo = run_block_pipeline_demo(axis, 8, ckpt_path=ckpt + "-demo", ckpt_every=2)
    torch.cuda.synchronize()
    c = dict(resumed_at=at, same=same, save_ms=a.pop("save_ms"), restore_ms=restore_ms,
             demo_s=time.perf_counter() - t0, demo_blocks=demo["num_blocks"])
    return dict(a=a, c=c, d=sharded_dense(axis, orbit_np))


def world4_slam_body(axis, frames_np, orbit_np) -> dict:
    """Phase 16 (b) and the world of 4 of (d), in one world of SHARDS gloo
    processes sharing the card."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.models.host_cache import ShardedHostCache
    from topfusion_tpu_torch.ops.blockmap import EMPTY_KEY
    from topfusion_tpu_torch.parallel import ShardedSlamSystem

    d = sharded_dense(axis, orbit_np)
    torch.cuda.empty_cache()
    frames = torch.from_numpy(frames_np).to(axis.device)
    slam = ShardedSlamSystem(sharded_slam_config(), axis)
    slam.swap = ShardedHostCache(slam.pipe, evict_batch=SHARDED_SLAM_EVICT,
                                 restore_batch=SHARDED_SLAM_RESTORE,
                                 headroom=slam.pipe.local_cfg.blockmap.capacity // 2)
    slam.warmup(SHARDED_SLAM_CHUNK)
    b = drive_sharded_slam(slam, frames, SHARDED_SLAM_CHUNK)
    b.update(slam_digest(slam), rank=axis.rank, host_end=slam.swap.n_host_blocks,
             local_blocks=int(slam.state.num_blocks),
             keys=slam.state.bucket_keys[slam.state.bucket_keys != EMPTY_KEY].cpu().numpy(),
             render=slam.render().cpu().numpy())
    b["kernel"] = kernel_on_local_pool(slam.state, slam.pipe.local_cfg, frames[-1])
    return dict(b=b, d=d)


def sharded_slam_phase(poses, frames, slam_a, dense_full) -> dict:
    """Phase 16.  ``slam_a``: phase 12 (a)'s frames and results;
    ``dense_full``: phase 10's full-march trajectory and state digest.
    Returns the kernel launches of the sharded SLAM paths."""
    import numpy as np
    import torch

    from topfusion_tpu_torch.io.trajectory import ate_rmse
    from topfusion_tpu_torch.parallel import spawn_world
    from topfusion_tpu_torch.parallel.multihost import measure_scaling, measure_scaling_block

    orbit_np = [f.cpu().numpy() for f in frames]
    pgc = slam_config().posegraph
    k, gn, cg = pgc.max_keyframes, pgc.gn_iters, pgc.cg_iters
    solve_calls, solve_bytes = gn * (cg + 3), gn * ((cg + 2) * k * 24 + k * 144)

    # (a) and (c): a world of one NCCL process against phase 12 (a).
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (w1,) = spawn_world(world1_body, 1, "nccl", "cuda", timeout_s=900,
                            args=(slam_a["frames"], orbit_np, os.path.join(tmp, "composed")))
    a, c = w1["a"], w1["c"]
    n = len(slam_a["frames"])
    expect = n + sum(a["refused"])
    print(f"16 (a), world of 1 ({time.perf_counter() - t0:.1f} s with (c), (d) and the spawn): "
          f"{a['banner']}")
    print(f"  {n} frames of phase 12 (a) in chunks of {SLAM_CHUNK}: loops {a['loops']}, "
          f"re-integrations {a['reint']} (re-fusing {a['refused']} frames); kernel launches "
          f"{a['launches']} ({a['vector_launches']} of the column kernel), implied {expect}; ms per "
          f"chunk {[round(x, 1) for x in a['chunk_ms']]} (phase 12 (a): "
          f"{[round(x, 1) for x in slam_a['chunk_ms']]}); host syncs per chunk {a['syncs']}; "
          f"collectives per chunk {a['calls']}, bytes {a['bytes']}; solves (calls, bytes) "
          f"{a['solves']} (computed {solve_calls}, {solve_bytes}); a solve on the warm card "
          f"{a['solve_ms']:.1f} ms; kernel vs plain on the local pool after the run: "
          f"{'bit-equal' if a['kernel']['equal'] else 'DIFFERENT'}")
    same = {key: (np.array_equal(a[key], slam_a[key]) if key in ("odom", "opt")
                  else a[key] == slam_a[key])
            for key in ("odom", "opt", "graph", "state", "loops", "reint", "num_kf", "num_edges")}
    print(f"  against phase 12 (a)'s SlamSystem, bit-identical: {same}")
    check(all(same.values()), f"16 (a): differs from phase 12 (a) in {[k for k, v in same.items() if not v]}")
    check(all(i["ok"] for i in a["infos"]), "16 (a): a frame failed to track")
    check(a["launches"] == expect == slam_a["launches"] and a["vector_launches"] == expect,
          f"16 (a): {a['launches']} launches, the code implies {expect}")
    for j, syncs in enumerate(a["syncs"]):
        size = min(SLAM_CHUNK, n - j * SLAM_CHUNK)
        if not any(i["loop"] for i in a["infos"][j * SLAM_CHUNK:(j + 1) * SLAM_CHUNK]):
            check(syncs <= size + 3, f"16 (a): chunk {j} of {size} frames synced {syncs} times")
    check(all(sv == (solve_calls, solve_bytes) for sv in a["solves"]) and a["solves"],
          f"16 (a): solves issued {a['solves']}, not {solve_calls} calls of {solve_bytes} B")
    check(a["kernel"]["equal"], "16 (a): kernel and plain differ on the local pool")
    print(f"16 (c): checkpoint after chunk {SLAM_SAVE_AT} saved in {c['save_ms']:.1f} ms, restored into a fresh "
          f"system in {c['restore_ms']:.1f} ms at frame {c['resumed_at']}; the resumed run "
          f"bit-identical to the uninterrupted one: {c['same']}; run_block_pipeline_demo "
          f"(8 frames, a checkpoint every 2) {c['demo_s']:.2f} s, {c['demo_blocks']} blocks")
    check(c["same"] and c["resumed_at"] == SLAM_SAVE_AT * SLAM_CHUNK,
          "16 (c): the resumed run differs")

    # (b) and (d)'s world of SHARDS: gloo processes sharing the card.
    from topfusion_tpu_torch.io.synthetic import SyntheticScene

    cam = slam_config().camera
    scene = SyntheticScene()
    gt_b = out_and_back(SHARDED_SLAM_FRAMES, SHARDED_SLAM_YAW, SHARDED_SLAM_SHIFT)
    frames_b = np.stack([scene.render_depth_mm(cam, torch.as_tensor(T, device=frames[0].device))
                         .cpu().numpy() for T in gt_b])
    t0 = time.perf_counter()
    ranks = spawn_world(world4_slam_body, SHARDS, "gloo", "cuda", timeout_s=900,
                        args=(frames_b, orbit_np))
    world4_s = time.perf_counter() - t0
    # (d) The sharded dense pipeline at phase 10's full march.
    d1, d4 = w1["d"], [r["d"] for r in ranks]
    same1 = (all(np.array_equal(x, y) for x, y in zip(d1["poses"], dense_full["poses"]))
             and d1["digest"] == dense_full["digest"])
    ate4 = ate_rmse(d4[0]["poses"], poses, align=False)
    maps4 = all(x["digest"][k] == d4[0]["digest"][k] for x in d4 for k in x["digest"]
                if k.startswith("model_"))
    print(f"16 (d), dense 256^3 full march over the orbit: world of 1 {d1['ms_per_frame']:.2f} "
          f"ms/frame, {d1['calls']:.0f} gathers and {d1['bytes']:.0f} B per frame, bit-identical "
          f"to phase 10: {same1}; world of {SHARDS} {[round(x['ms_per_frame'], 2) for x in d4]} "
          f"ms/frame, {d4[0]['calls']:.0f} gathers and {d4[0]['bytes']:.0f} B per rank per frame, "
          f"ATE {ate4 * 1000:.3f} mm, model maps identical over the ranks {maps4}")
    check(same1, "16 (d): the world of 1 differs from phase 10's DensePipeline")
    check(all(all(x["ok"]) for x in d4) and ate4 < ATE_LIMIT_M, f"16 (d): ATE {ate4} m")
    check(maps4, "16 (d): the ranks' model maps differ")

    # (e) The scaling harness on this card.
    cfg_e = bench_config()
    t0 = time.perf_counter()
    blk = measure_scaling_block(cfg_e, n_frames=SCALING_FRAMES, device_counts=(1, SHARDS))
    dense = measure_scaling(dense_config(), n_frames=SCALING_FRAMES, device_counts=(1, SHARDS))
    print(f"16 (e), one card: overhead and contention, not scaling ({time.perf_counter() - t0:.1f} s): "
          f"measure_scaling_block {blk}; measure_scaling {dense}")
    check(blk["efficiency"] is None and dense["efficiency"] is None,
          "16 (e): an efficiency from processes that share one card")

    bs = [r["b"] for r in ranks]
    b = bs[0]
    nb = len(frames_b)
    odom = ate_rmse(list(b["odom"]), gt_b, align=False)
    opt = ate_rmse(list(b["opt"]), gt_b, align=False)
    keys = np.concatenate([x["keys"] for x in bs])
    host = sum(x["host_end"] for x in bs)
    live = sum(x["local_blocks"] for x in bs)
    dropped = sum(i["dropped"] for i in b["infos"])
    # Blocks the run holds after each chunk's step and eviction: live on
    # the card (the last frame's total) and on the shards' hosts.
    held = [b["infos"][min((j + 1) * SHARDED_SLAM_CHUNK, nb) - 1]["blocks"]
            + sum(x["host"][j] for x in bs) for j in range(len(b["chunk_ms"]))]
    live_most = SHARDED_SLAM_CAP // 2
    print(f"16 (b), world of {SHARDS} ({world4_s:.1f} s with (d) and the spawn): "
          f"{nb} frames out and back ({SHARDED_SLAM_YAW} rad, {SHARDED_SLAM_SHIFT} m at the turn) in "
          f"chunks of {SHARDED_SLAM_CHUNK}, pool {SHARDED_SLAM_CAP} blocks over the shards, at most "
          f"{live_most} live after a chunk (the caches' headroom), ring {SHARDED_SLAM_CHUNK}: loops "
          f"{b['loops']}, re-integrations {b['reint']} (re-fusing "
          f"{b['refused']} frames); ATE odometry {odom * 1000:.3f} mm, optimized {opt * 1000:.3f} mm; "
          f"blocks dropped {dropped}, live + host after each chunk {held}, at the end live {live} + "
          f"host {host}; remap_store {b['remaps']}; launches per rank "
          f"{[x['launches'] for x in bs]}; ms per chunk {[round(x, 1) for x in b['chunk_ms']]}; "
          f"collectives per chunk {b['calls']}; kernel vs plain on the local pools: "
          f"{['bit-equal' if x['kernel']['equal'] else 'DIFFERENT' for x in bs]}")
    check(all(i["ok"] for x in bs for i in x["infos"]), "16 (b): a frame failed to track")
    check(b["loops"] >= 1 and b["reint"] >= 1, "16 (b): no loop closed and rebuilt the map")
    check(opt < ATE_LIMIT_M, f"16 (b): optimized ATE {opt} m")
    check(dropped == 0, f"16 (b): {dropped} blocks dropped")
    check(max(held) > live_most,
          f"16 (b): premise: the run holds {max(held)} blocks, no more than {live_most} live")
    check(any(m["host_before"] > 0 and m["entries"] > 0 for m in b["remaps"]),
          "16 (b): remap_store never ran with blocks on the hosts")
    for x in bs[1:]:
        for key in ("odom", "opt"):
            check(np.array_equal(x[key], b[key]), f"16 (b): rank {x['rank']}'s {key} differs")
        check(x["graph"] == b["graph"], f"16 (b): rank {x['rank']}'s graph differs")
        check(np.array_equal(x["render"], b["render"]), f"16 (b): rank {x['rank']}'s render differs")
    check(len(np.unique(keys)) == len(keys), "16 (b): a block is on two shards")
    for x in bs:
        want = nb + sum(x["refused"])
        check(x["launches"] == want == x["vector_launches"],
              f"16 (b): rank {x['rank']}: {x['launches']} launches, the code implies {want}")
        check(x["kernel"]["equal"], f"16 (b): rank {x['rank']}: kernel and plain differ")

    return {"slam_sharded_world1": a["launches"],
            "slam_sharded_world4": sum(x["launches"] for x in bs)}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    try:
        import topfusion_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 1

    from topfusion_tpu_torch.io.synthetic import SyntheticScene, orbit_trajectory

    try:
        smi = banner()
        device = torch.device("cuda", 0)
        build_kernel()
        poses = orbit_trajectory(FRAMES, max_angle_deg=3.0, max_shift=0.03, seed=1)
        cfg = bench_config()
        t0 = time.perf_counter()
        frames = render_frames(cfg, poses, device)
        torch.cuda.synchronize()
        print(f"rendered {len(frames)} frames {tuple(frames[0].shape)} "
              f"{frames[0].dtype} in {time.perf_counter() - t0:.2f} s")
        clock = [time.perf_counter()]

        def took(phase: str) -> None:
            torch.cuda.synchronize()
            clock.append(time.perf_counter())
            print(f"[{phase} took {clock[-1] - clock[-2]:.1f} s]")

        k = kernel_vs_plain(frames, poses, device)
        generic_path_check(frames, poses, device)
        took("phase 3, kernel against plain")
        pipe, fused, est, step_launches, flat_profile = main_path(frames, poses, device)
        phase4 = dict(poses=[T.cpu().numpy() for T in est], digest=state_digest(fused),
                      num_blocks=int(fused.num_blocks))
        took("phases 4-5, main path")
        display_phase(pipe, fused, device)
        took("phase 6, display")
        launches = {"step": step_launches,
                    "step_raycast_model_maps": raycast_model_maps_phase(frames, poses, device)}
        took("phase 7, raycast model maps")
        scene = SyntheticScene()
        rgbs = [scene.render_rgb(cfg.camera, torch.as_tensor(T, dtype=torch.float32, device=device))
                for T in poses]
        launches["step_rgb"] = color_phase(frames, rgbs, poses, est, device)
        took("phase 8, color")
        pointcloud_phase(pipe, fused)
        took("phase 9, point cloud")
        del pipe, fused
        torch.cuda.empty_cache()
        dense_full = dense_phase(frames, rgbs, poses, device)
        took("phase 10, dense")
        torch.cuda.empty_cache()
        launches["step_out_of_core_sweep"], sweep = swap_phase(device)
        took("phase 11, out-of-core sweep")
        torch.cuda.empty_cache()
        slam_launches, slam_a = slam_phase(device)
        launches.update(slam_launches)
        took("phase 12, SLAM")
        launches["step_icp_onehot"] = onehot_phase(frames, poses, est, flat_profile, device)
        took("phase 13, ICP one-hot")
        launches["step_negative_fy"] = negative_fy_phase(poses, est, device)
        took("phase 14, fy < 0")
        torch.cuda.empty_cache()
        launches.update(sharded_phase(poses, frames, phase4, sweep))
        took("phase 15, sharded block map")
        launches.update(sharded_slam_phase(poses, frames, slam_a, dense_full))
        took("phase 16, sharded SLAM system")
    except Exception:  # every phase failure ends the run with exit code 1
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [{
        "name": "integrate_blocks",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "kernel_ms": k["kernel_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
