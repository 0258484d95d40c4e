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
     (c) the app as a subprocess, ``--synthetic 60 --synthetic-vga``: exit
     0, every output file, optimized ATE < 12 mm.

The kernel's launch count is set to 0 before each of the stepping paths
(4, 7, 8, the capped sweep of 11, and 12 (a) and (b)) and read after it;
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


def kernel_vs_plain(frames, poses, device) -> dict:
    """Phase 3.  Returns the int16 result (the bench's pool dtype)."""
    import torch

    from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
    from topfusion_tpu_torch.ops.blockmap import decode_tsdf
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda, launch_plan
    from topfusion_tpu_torch.ops.depth import depth_to_meters
    from topfusion_tpu_torch.ops.tsdf_block import (
        allocate_from_depth,
        integrate_blocks,
        visible_blocks,
    )

    results = {}
    for dtype in ("int16", "float32", "bfloat16"):
        cfg = with_plain_integrate(bench_config(dtype))
        pipe = BlockPipeline(cfg, device)
        state, _, _ = run(pipe, pipe.init(), frames[:3])
        cam, tc, bm = cfg.camera, cfg.tsdf, cfg.blockmap
        T = torch.as_tensor(poses[3], dtype=torch.float32, device=device)
        raw = depth_to_meters(frames[3], cfg.preproc.max_sensor_depth)
        m, _ = allocate_from_depth(state.block_map(), cam, tc, bm, T, raw)
        vis = visible_blocks(m, cam, tc, bm, T, depth=raw)

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
    launches of the main-path run)."""
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
    profile_pass(pipe, state, frames)
    return pipe, fused, est, launches


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


def profile_pass(pipe, state, frames) -> None:
    """One pass over the frames under the profiler: device operations and
    their summed device time per frame, the device's busy share of the
    pass's wall time (which the profiler's own cost inflates), and the
    five kernels that take the most device time."""
    n = len(frames)
    ops, device_ms, wall_ms, us_by_name = profiled(lambda: run(pipe, state, frames))
    if device_ms == 0.0:
        print("profiled pass: the profiler recorded no device time (not measured)")
        return
    print(f"profiled pass: {ops / n:.1f} device ops/frame, device time "
          f"{device_ms / n:.3f} ms/frame, wall {wall_ms / n:.3f} ms/frame, "
          f"device busy share {device_ms / wall_ms:.4f}")
    for name, us in us_by_name.most_common(5):
        print(f"  {us / 1000 / n:8.3f} ms/frame  {name[:100]}")


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


def dense_phase(frames, rgbs, poses, device) -> None:
    """Phase 10."""
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


def swap_phase(device) -> int:
    """Phase 11.  Returns the kernel launches of the capped sweep."""
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
    return launches


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


def out_and_back(n: int):
    """tests/test_slam.py's out-and-back: 0.08 rad of yaw and 0.10 m along x
    at the turn, back to the start."""
    import math

    import torch

    from topfusion_tpu_torch.geometry.se3 import se3_exp

    return [se3_exp(torch.tensor([0, 0.08 * s, 0, 0.10 * s, 0.02 * s, 0])).numpy()
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


def slam_phase(device) -> dict:
    """Phase 12.  Returns the kernel launches of (a) and (b)."""
    import os

    import numpy as np
    import torch

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
               "--out", out]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=SLAM_APP_TIMEOUT_S,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        print(f"slam (c): {' '.join(cmd[1:4])} ... exited {res.returncode} in {secs:.1f} s")
        print("\n".join("  | " + line for line in res.stdout.strip().splitlines()[-6:]))
        check(res.returncode == 0, f"slam (c): the app failed:\n{res.stderr[-3000:]}")
        names = sorted(os.listdir(out))
        want = ["cloud.ply", "metrics.json", "metrics.jsonl", "render_final.png", "state.npz",
                "trajectory_odom.txt", "trajectory_opt.txt"]
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
    return {"slam": a["launches"], "slam_reintegrate": b_launches}


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
        pipe, fused, est, step_launches = main_path(frames, poses, device)
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
        dense_phase(frames, rgbs, poses, device)
        took("phase 10, dense")
        torch.cuda.empty_cache()
        launches["step_out_of_core_sweep"] = swap_phase(device)
        took("phase 11, out-of-core sweep")
        torch.cuda.empty_cache()
        launches.update(slam_phase(device))
        took("phase 12, SLAM")
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
