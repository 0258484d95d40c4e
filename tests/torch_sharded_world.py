"""World bodies of the sharded-pipeline tests.

They run in the processes that ``topfusion_tpu_torch.parallel.launch.
spawn_world`` starts, one per shard, so this module imports torch and the
port only: never jax, ``tests/conftest.py`` or a test module.  Inputs
come from a pickle file that the test wrote; each body returns numpy
values for the test to hold against the JAX package.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from topfusion_tpu_torch.convert import (
    _to_tensor,
    block_state_from_numpy,
    block_state_to_numpy,
    sharded_block_state_from_numpy,
)
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline, shade
from topfusion_tpu_torch.models.host_cache import ShardedHostCache
from topfusion_tpu_torch.ops.tsdf_block import raycast_blocks
from topfusion_tpu_torch.parallel import MapAxis, ShardedBlockPipeline, dryrun_sharded_block_step
from topfusion_tpu_torch.utils.device_info import mesh_banner


def aux_numpy(aux) -> dict:
    return {k: np.asarray(v) for k, v in aux._asdict().items()}


def pipeline_world(axis: MapAxis, inputs_path: str) -> dict:
    """Everything the pipeline test checks, in one world:

    * ``carried``: each frame stepped from the JAX state before it (the
      initial state for frame 0), the local state and aux after it;
    * ``free``: the frames stepped freely from ``init``: poses, aux, and
      the last local state;
    * ``reset``: an all-zero frame from the JAX state after the last
      frame, then the first frame from the JAX state after that;
    * ``pallas``: one frame with ``use_pallas_integrate`` on (the kernel's
      wrapper, plain on CPU tensors) from the JAX state before it;
    * ``render``: the sharded render of the JAX state after the last frame;
    * ``world1`` (rank 0): a world of one shard on a group of this rank
      alone, against ``BlockPipeline`` over the same frames, and its
      render against the single-device march with the same gate;
    * the dry run of ``dryrun_sharded_block_step``.
    """
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg, frames, ns = inp["cfg"], [torch.from_numpy(f) for f in inp["frames"]], axis.size
    rank = axis.rank
    pipe = ShardedBlockPipeline(cfg, axis, device="cpu")

    def carry(arrays):
        return sharded_block_state_from_numpy(arrays, rank, ns, device="cpu")

    out = {"banner": mesh_banner(axis), "local_cfg": pipe.local_cfg}
    out["init"] = block_state_to_numpy(pipe.init())

    carried = []
    for i, f in enumerate(frames):
        st = pipe.init() if i == 0 else carry(inp["jax_states"][i - 1])
        calls0, bytes0 = axis.calls, axis.bytes
        st, aux = pipe.step(st, f)
        carried.append(dict(state=block_state_to_numpy(st), aux=aux_numpy(aux),
                            calls=axis.calls - calls0, bytes=axis.bytes - bytes0))
    out["carried"] = carried

    st = pipe.init()
    poses, auxes = [], []
    for f in frames:
        st, aux = pipe.step(st, f)
        poses.append(st.T_wc.numpy().copy())
        auxes.append(aux_numpy(aux))
    out["free"] = dict(poses=poses, aux=auxes, state=block_state_to_numpy(st))

    last = carry(inp["jax_states"][-1])
    z, za = pipe.step(last, torch.zeros_like(frames[0]))
    again, aa = pipe.step(carry(inp["jax_zero_state"]), frames[0])
    out["reset"] = dict(zero=block_state_to_numpy(z), zero_aux=aux_numpy(za),
                        again=block_state_to_numpy(again), again_aux=aux_numpy(aa))

    k = inp["pallas_frame"]
    pp = ShardedBlockPipeline(inp["cfg_pallas"], axis, device="cpu")
    ps, pa = pp.step(carry(inp["jax_states"][k - 1]), frames[k])
    out["pallas"] = dict(state=block_state_to_numpy(ps), aux=aux_numpy(pa))

    out["render"] = pipe.render(last).numpy()

    # Every rank makes every singleton group (new_group is collective).
    singles = [dist.new_group([r]) for r in range(ns)]
    if rank == 0:
        one = ShardedBlockPipeline(cfg, MapAxis(singles[0], "cpu"), device="cpu")
        ref = BlockPipeline(cfg, device="cpu")
        so, sr, same = one.init(), ref.init(), []
        for f in frames:
            so, ao = one.step(so, f)
            sr, ar = ref.step(sr, f)
            same.append(all(torch.equal(a, b) for a, b in zip(
                [*so[:8], *so.model_points, *so.model_normals, so.vis_slots, *ao],
                [*sr[:8], *sr.model_points, *sr.model_normals, sr.vis_slots, *ar])))
        out["world1_same"] = same
        out["world1_num_blocks"] = int(so.num_blocks)
        lc = one.local_cfg
        rc = raycast_blocks(so.block_map(), lc.camera, lc.tsdf, lc.blockmap, lc.raycast,
                            so.T_wc, weight_gate="nearest")
        out["world1_render_same"] = torch.equal(one.render(so), shade(rc.points, rc.normals, so.T_wc))
    dist.barrier()

    dryrun_sharded_block_step(ns, axis, "cpu")
    out["dryrun"] = True
    return out


def sweep_world(axis: MapAxis, inputs_path: str) -> dict:
    """The corridor sweep of the sharded out-of-core test: an uncapped run,
    then a capped run with a ``ShardedHostCache`` on every shard (restore
    before each step from the last pose, evict after it).  Returns each
    run's poses, per-frame aux and final live count, and the capped run's
    store size, restores and evictions on this shard; and under
    ``carried`` the frames stepped from the JAX run (``carried_frames``)."""
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    frames = [torch.from_numpy(f) for f in inp["frames"]]
    out = {}
    for name, cfg in (("uncapped", inp["cfg_big"]), ("capped", inp["cfg_small"])):
        pipe = ShardedBlockPipeline(cfg, axis, device="cpu")
        cache = (ShardedHostCache(pipe, evict_batch=inp["evict_batch"],
                                  restore_batch=inp["restore_batch"])
                 if name == "capped" else None)
        state = pipe.init()
        poses, auxes, restored, evicted = [], [], [], []
        for f in frames:
            if cache is not None:
                n0 = cache.n_host_blocks
                T_pred = poses[-1] if poses else np.eye(4, dtype=np.float32)
                state = cache.before_step(state, T_pred)
                restored.append(n0 - cache.n_host_blocks)
            state, aux = pipe.step(state, f)
            poses.append(state.T_wc.numpy().copy())
            auxes.append(aux_numpy(aux))
            if cache is not None:
                n0 = cache.n_host_blocks
                state = cache.after_step(state)
                evicted.append(cache.n_host_blocks - n0)
        out[name] = dict(poses=poses, aux=auxes, live=int(state.num_blocks),
                         vis_ok=bool(((state.vis_slots < state.num_blocks)).all()))
        if cache is not None:
            out[name].update(host=cache.n_host_blocks, restored=restored, evicted=evicted,
                             model_points=state.model_points[0].numpy())
    out["carried"] = carried_frames(axis, inp, frames)
    return out


def carried_frames(axis: MapAxis, inp: dict, frames) -> list:
    """Frames of the capped sweep, each from the JAX run's state and this
    shard's part of its ``ShardedHostCache`` (store, recency, clock)
    before it: restore from the JAX pose, step, evict.  ``inp
    ["carried_paths"][rank]`` holds them for this rank.  Returns, per
    frame, the slots of each evict round, the restored mask of each
    insert, the store's keys in order, the recency, the local state after
    the eviction and the step's aux."""
    with open(inp["carried_paths"][axis.rank], "rb") as f:
        rows = pickle.load(f)
    pipe = ShardedBlockPipeline(inp["cfg_small"], axis, device="cpu")
    cache = ShardedHostCache(pipe, evict_batch=inp["evict_batch"],
                             restore_batch=inp["restore_batch"])
    evicts, inserts = [], []
    swap_evict, swap_insert = pipe.swap_evict, pipe.swap_insert

    def record_evict(state, slots):
        evicts.append(slots.cpu().numpy().copy())
        return swap_evict(state, slots)

    def record_insert(state, blocks):
        state, ok = swap_insert(state, blocks)
        inserts.append(ok.cpu().numpy().copy())
        return state, ok

    pipe.swap_evict, pipe.swap_insert = record_evict, record_insert
    out = []
    for row in rows:
        evicts.clear()
        inserts.clear()
        cache.store = {k: tuple(None if a is None else _to_tensor(a, "cpu") for a in v)
                       for k, v in row["store"].items()}
        cache.last_seen = row["last_seen"].copy()
        cache._frame = row["clock"]
        state = block_state_from_numpy(row["state"], device="cpu")
        state = cache.before_step(state, row["T_prev"])
        state, aux = pipe.step(state, frames[row["frame"]])
        state = cache.after_step(state)
        out.append(dict(frame=row["frame"], evicts=list(evicts), inserts=list(inserts),
                        keys=list(cache.store.keys()), last_seen=cache.last_seen.copy(),
                        state=block_state_to_numpy(state), aux=aux_numpy(aux)))
    return out


# ----------------------------------------------------------------- on the card
def count_syncs(fn):
    """(result, messages of the synchronizing calls PyTorch detected)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in rec
                 if str(w.message).startswith("called a synchronizing")]


def card_world_of_one(axis: MapAxis, cfg, n_frames: int) -> dict:
    """A world of one shard on the card against ``BlockPipeline`` over the
    first ``n_frames`` of the test orbit: whether every step's state, model
    maps and aux are bit-identical, the integrate kernel's launches, and
    the host syncs of one more (warm) sharded step."""
    from topfusion_tpu_torch.io.synthetic import SyntheticScene, orbit_trajectory
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda

    dev = axis.device
    scene = SyntheticScene()
    poses = orbit_trajectory(n_frames + 1, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [scene.render_depth_mm(cfg.camera, torch.as_tensor(T, device=dev)) for T in poses]
    one = ShardedBlockPipeline(cfg, axis, device=dev)
    ref = BlockPipeline(cfg, device=dev)
    so, sr, same = one.init(), ref.init(), []
    integrate_blocks_cuda.launches = 0
    for f in frames[:n_frames]:
        so, ao = one.step(so, f)
        sr, ar = ref.step(sr, f)
        same.append(all(torch.equal(a, b) for a, b in zip(
            [*so[:8], *so.model_points, *so.model_normals, so.vis_slots, *ao],
            [*sr[:8], *sr.model_points, *sr.model_normals, sr.vis_slots, *ar])))
    torch.cuda.synchronize()
    launches = integrate_blocks_cuda.launches
    (_, aux), syncs = count_syncs(lambda: one.step(so, frames[n_frames]))
    return dict(same=same, launches=launches, syncs=syncs, ok=bool(aux.ok))


def card_collectives(axis: MapAxis) -> dict:
    """The map axis's collectives on CUDA tensors: each collective's
    result against the value it must have."""
    dev, r, n = axis.device, axis.rank, axis.size
    x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * r
    s = axis.psum(x)
    m = axis.pmin(-x)
    g = axis.all_gather_tiled(torch.full((2, 3), r, dtype=torch.int32, device=dev))
    b = axis.all_gather_tiled(torch.tensor([r % 2 == 0], device=dev))
    G, c = axis.psum_gram(torch.full((7, 7), float(r + 1), device=dev),
                          torch.tensor(100 + r, dtype=torch.int32, device=dev))
    want_sum = n * torch.arange(6.0) + 10 * sum(range(n))
    return dict(
        devices=[t.device.type for t in (s, m, g, b, G, c)],
        psum=torch.equal(s.cpu(), want_sum),
        pmin=torch.equal(m.cpu(), -(torch.arange(6.0) + 10 * (n - 1))),
        gather=torch.equal(g.cpu(), torch.arange(n, dtype=torch.int32).repeat_interleave(2)[:, None]
                           .expand(2 * n, 3)),
        gather_bool=b.dtype == torch.bool and b.cpu().tolist() == [i % 2 == 0 for i in range(n)],
        gram=bool((G.cpu() == n * (n + 1) / 2).all()) and int(c) == 100 * n + sum(range(n)),
        calls=axis.calls,
    )


# ------------------------------------------------------ the sharded SLAM system
def slam_values(slam) -> dict:
    from topfusion_tpu_torch.convert import sharded_slam_state_to_numpy

    return sharded_slam_state_to_numpy(slam)


def _chunks(slam, frames, c0: int, c1: int, size: int) -> list:
    infos = []
    for c in range(c0, c1):
        infos += slam.process_chunk(frames[c * size:(c + 1) * size])
    return infos


def slam_world(axis: MapAxis, inputs_path: str) -> dict:
    """Everything the sharded SLAM test checks, in one world:

    * ``carried``: each chunk processed from the JAX system's values
      before it (``convert.sharded_slam_state_from_numpy``); this shard's
      values and infos after it, and the collectives it issued;
    * ``free``: the chunks processed freely, with the composed checkpoint
      saved after ``inp["save_at"]`` chunks and once more a chunk later;
      the trajectories, graph, counters and this shard's map;
    * ``resumed``: a fresh system restored from the first checkpoint and
      run over the remaining chunks, bit-identical to ``free`` or not;
    * ``mixed``: what restoring a checkpoint whose shard 1 map comes from
      the later save raised (None: nothing);
    * ``remap``: ``remap_store`` of the stores of ``inp["remap"]``.
    """
    from topfusion_tpu_torch.convert import sharded_slam_state_from_numpy
    from topfusion_tpu_torch.parallel import ShardedSlamSystem

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg, size, rank = inp["cfg"], inp["chunk"], axis.rank
    frames = torch.from_numpy(inp["frames"])
    n_chunks = len(frames) // size
    out = {}

    slam = ShardedSlamSystem(cfg, axis, device="cpu")
    carried = []
    for c, values in enumerate(inp["before"]):
        sharded_slam_state_from_numpy(values, slam)
        calls0, bytes0 = axis.calls, axis.bytes
        infos = _chunks(slam, frames, c, c + 1, size)
        carried.append(dict(values=slam_values(slam), infos=infos,
                            calls=axis.calls - calls0, bytes=axis.bytes - bytes0))
    out["carried"] = carried

    ck, later, save_at = inp["ckpt"], inp["ckpt"] + "-later", inp["save_at"]
    free = ShardedSlamSystem(cfg, axis, device="cpu")
    infos = _chunks(free, frames, 0, save_at, size)
    free.save_checkpoint(ck)
    infos += _chunks(free, frames, save_at, save_at + 1, size)
    free.save_checkpoint(later)
    infos += _chunks(free, frames, save_at + 1, n_chunks, size)
    out["free"] = dict(infos=infos, odom=np.stack(free.odom_poses),
                       opt=np.stack(free.optimized_trajectory()), values=slam_values(free),
                       loops=free.loops_closed, reint=free.reintegrations)

    res = ShardedSlamSystem(cfg, axis, device="cpu")
    res.restore_checkpoint(ck)
    resumed_at = res.frame_idx
    _chunks(res, frames, save_at, n_chunks, size)
    same = (np.array_equal(np.stack(res.odom_poses), out["free"]["odom"])
            and all(torch.equal(a, b) for a, b in zip(res.graph, free.graph))
            and all(torch.equal(a, b) for a, b in zip(
                [*res.state[:8], *res.state.model_points, res.state.vis_slots],
                [*free.state[:8], *free.state.model_points, free.state.vis_slots]))
            and res.loops_closed == free.loops_closed
            and res.reintegrations == free.reintegrations)
    out["resumed"] = dict(at=resumed_at, same=same)

    # A checkpoint whose shard 1 map is from the later save.
    import shutil

    mixed = inp["ckpt"] + "-mixed"
    shutil.copy(f"{later if rank == 1 else ck}.map.proc{rank}.npz", f"{mixed}.map.proc{rank}.npz")
    if rank == 0:
        for ext in (".rep.npz", ".host.json"):
            shutil.copy(ck + ext, mixed + ext)
    dist.barrier()
    fresh = ShardedSlamSystem(cfg, axis, device="cpu")
    try:
        fresh.restore_checkpoint(mixed)
        out["mixed"] = None
    except RuntimeError as e:
        out["mixed"] = str(e)

    out["remap"] = remap_world(axis, inp["remap"])
    return out


def remap_world(axis: MapAxis, cases: dict) -> dict:
    """``ShardedHostCache.remap_store`` of this shard's store of every case
    (``cases[name]``: the config, the correction and every shard's store
    as numpy, in insertion order): the new store's keys in order and its
    payloads as numpy, and the counts it returns."""
    from topfusion_tpu_torch.convert import _to_tensor

    out = {}
    for name, case in cases.items():
        pipe = ShardedBlockPipeline(case["cfg"], axis, device="cpu")
        cache = ShardedHostCache(pipe)
        cache.store = {k: tuple(None if a is None else _to_tensor(a, "cpu") for a in v)
                       for k, v in case["stores"][axis.rank].items()}
        calls0 = axis.calls
        stats = cache.remap_store(case["corr"])
        out[name] = dict(keys=list(cache.store.keys()), stats=stats, calls=axis.calls - calls0,
                         payloads=[tuple(None if a is None else a.numpy() for a in v)
                                   for v in cache.store.values()])
    return out


# ------------------------------------------------ distributed bundle adjustment
def dist_ba_world(axis: MapAxis, inputs_path: str) -> dict:
    """``optimize_distributed`` of the carried graph on this world (poses,
    chi2, the collectives it issued), the composed system's solve with
    ``solver="dense"`` on the same graph; on rank 0, in a world of one
    shard, ``optimize_distributed`` against ``optimize_pcg``; and over the
    frames at ``inp["poses"]`` a ``ShardedSlamSystem`` on that world of
    one (rank 0) and a ``SlamSystem`` (rank 1): their trajectories,
    graphs, maps and counters (``slam_run``)."""
    from topfusion_tpu_torch.convert import pose_graph_from_numpy
    from topfusion_tpu_torch.models.posegraph import optimize_pcg
    from topfusion_tpu_torch.models.slam import SlamSystem
    from topfusion_tpu_torch.parallel import ShardedSlamSystem, optimize_distributed

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    pg = pose_graph_from_numpy(inp["graph"], device="cpu")
    calls0, bytes0 = axis.calls, axis.bytes
    g, chi2 = optimize_distributed(pg, inp["pg_cfg"], axis)
    out = dict(poses=g.kf_poses.numpy(), chi2=float(chi2), calls=axis.calls - calls0,
               bytes=axis.bytes - bytes0)

    slam = ShardedSlamSystem(inp["slam_cfg_dense"], axis, device="cpu")
    calls0 = axis.calls
    gs, _, _ = slam._optimize_ex(pg, torch.eye(4))
    out["dense_solver"] = dict(same=torch.equal(gs.kf_poses, g.kf_poses), calls=axis.calls - calls0)

    # Rank 0 runs a world of one shard, rank 1 the single-device system
    # on the same frames, side by side; the test compares their runs.
    singles = [dist.new_group([r]) for r in range(axis.size)]
    size = inp["chunk"]
    slam = None
    if axis.rank == 0:
        one = MapAxis(singles[0], "cpu")
        g1, c1 = optimize_distributed(pg, inp["pg_cfg"], one)
        gp, cp = optimize_pcg(pg, inp["pg_cfg"])
        out["world1_pcg"] = dict(same=all(torch.equal(a, b) for a, b in zip(g1, gp))
                                 and torch.equal(c1, cp), calls=one.calls, bytes=one.bytes)
        slam = ShardedSlamSystem(inp["slam_cfg"], one, device="cpu")
    elif axis.rank == 1:
        slam = SlamSystem(inp["slam_cfg"], device="cpu")
    if slam is not None:
        from topfusion_tpu_torch.io.synthetic import SyntheticScene

        cam = inp["slam_cfg"].camera
        frames = torch.stack([SyntheticScene().render_depth_mm(cam, torch.from_numpy(T))
                              for T in inp["poses"]])
        for c in range(len(frames) // size):
            slam.process_chunk(frames[c * size:(c + 1) * size])
        out["slam_run"] = dict(
            odom=np.stack(slam.odom_poses), opt=np.stack(slam.optimized_trajectory()),
            graph=[t.numpy() for t in slam.graph],
            state=[t.numpy() for t in (*slam.state[:8], *slam.state.model_points,
                                       *slam.state.model_normals, slam.state.vis_slots)],
            loops=slam.loops_closed, reint=slam.reintegrations)
    dist.barrier()
    return out


# ------------------------------------------------------- the sharded dense step
def dense_world(axis: MapAxis, inputs_path: str) -> dict:
    """``make_sharded_pipeline`` over ``inp["frames"]`` from ``init``: this
    shard's state and aux after each frame, the gathered bytes per frame;
    on rank 0, in a world of one shard, whether every step is
    ``DensePipeline``'s bit for bit; and ``dryrun_sharded_step``."""
    from topfusion_tpu_torch.convert import dense_state_to_numpy
    from topfusion_tpu_torch.models.pipeline import DensePipeline
    from topfusion_tpu_torch.parallel import dryrun_sharded_step, make_sharded_pipeline

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg = inp["cfg"]
    frames = [torch.from_numpy(f) for f in inp["frames"]]
    init, step = make_sharded_pipeline(cfg, axis, device="cpu")
    st, steps = init(), []
    for f in frames:
        calls0, bytes0 = axis.calls, axis.bytes
        st, aux = step(st, f)
        steps.append(dict(state=dense_state_to_numpy(st), aux=aux_numpy(aux),
                          calls=axis.calls - calls0, bytes=axis.bytes - bytes0))
    out = dict(steps=steps)
    singles = [dist.new_group([r]) for r in range(axis.size)]
    if axis.rank == 0:
        init1, step1 = make_sharded_pipeline(cfg, MapAxis(singles[0], "cpu"), device="cpu")
        ref = DensePipeline(cfg, device="cpu")
        a, b, same = init1(), ref.init(), []
        for f in frames:
            a, aa = step1(a, f)
            b, ab = ref.step(b, f)
            same.append(all(torch.equal(x, y) for x, y in zip(
                [a.tsdf, a.weight, a.color, a.T_wc, *a.model_points, *a.model_normals, *aa],
                [b.tsdf, b.weight, b.color, b.T_wc, *b.model_points, *b.model_normals, *ab])))
        out["world1_same"] = same
    dist.barrier()
    dryrun_sharded_step(axis.size, axis, "cpu")
    out["dryrun"] = True
    return out


# ------------------------------------------------------------------ multihost
def demo_world(axis: MapAxis, n_frames: int, ckpt: str | None = None, crash_at: int = -1) -> dict:
    """``run_block_pipeline_demo`` on this world, checkpointing every 2
    frames to ``ckpt``; rank 1 dies hard after frame ``crash_at``."""
    import os

    from topfusion_tpu_torch.parallel.multihost import run_block_pipeline_demo

    def on_frame(k, state):
        if axis.rank == 1 and k + 1 == crash_at:
            os._exit(17)

    return run_block_pipeline_demo(axis, n_frames, ckpt_path=ckpt, ckpt_every=2 if ckpt else 0,
                                   on_frame=on_frame)


def env_world_child(rank: int, n: int, port: int, out_path: str) -> None:
    """One process of a world that ``initialize_multihost`` forms from the
    environment a launcher sets; writes the backend, rank, size and a
    ``psum`` of the ranks to ``out_path``."""
    import os

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(n))
    from topfusion_tpu_torch.parallel import initialize_multihost, make_mesh

    backend = initialize_multihost()
    axis = make_mesh("cpu")
    total = axis.psum(torch.tensor([float(axis.rank)]))
    with open(out_path, "wb") as f:
        pickle.dump(dict(backend=backend, rank=axis.rank, size=axis.size, total=float(total)), f)
    dist.destroy_process_group()


def drifted_graph(device):
    """tests/test_parallel.py's drifted graph in the port: 8 keyframes
    with drift, 7 odometry edges at the true motion and a loop edge 0-7,
    16 keyframe and 64 edge slots.  Returns (graph, its PoseGraphConfig)."""
    from topfusion_tpu_torch.config import PoseGraphConfig
    from topfusion_tpu_torch.geometry.se3 import se3_exp, se3_inverse
    from topfusion_tpu_torch.models.posegraph import add_keyframe, make_pose_graph

    from topfusion_tpu_torch.config import CameraConfig

    cam_l = CameraConfig(width=20, height=16, fx=15.0, fy=15.0, cx=10.0, cy=8.0)
    cfg = PoseGraphConfig(max_keyframes=16, max_edges=64, gn_iters=6)
    pg = make_pose_graph(cfg, cam_l, device)
    ones = torch.ones((cam_l.height, cam_l.width, 3), device=device)

    def twist(i, drift):
        return se3_exp(torch.tensor([0, 0, 0.01 * i, 0.05 * i, drift * i, 0], device=device))

    true = [twist(i, 0.0) for i in range(8)]
    for i in range(8):
        pg = add_keyframe(pg, twist(i, 0.012), ones, ones, torch.tensor(i, device=device),
                          torch.tensor(True, device=device))
    eT = pg.edge_T.clone()
    for e in range(7):
        eT[e] = se3_inverse(true[e]) @ true[e + 1]
    eT[7] = se3_inverse(true[0]) @ true[7]
    ei, ej, loop = pg.edge_i.clone(), pg.edge_j.clone(), pg.edge_is_loop.clone()
    ei[7], ej[7], loop[7] = 0, 7, True
    pg = pg._replace(edge_T=eT, edge_i=ei, edge_j=ej, edge_is_loop=loop,
                     num_edges=torch.tensor(8, dtype=torch.int32, device=device))
    return pg, cfg


def card_dist_ba_world_of_one(axis: MapAxis) -> dict:
    """``optimize_distributed`` on a world of one shard on the card
    against ``optimize_pcg`` on the drifted graph: bit-equal or not, the
    collectives it issued, and the host syncs of the solve."""
    from topfusion_tpu_torch.models.posegraph import optimize_pcg
    from topfusion_tpu_torch.parallel import optimize_distributed

    pg, cfg = drifted_graph(axis.device)
    g1, c1 = optimize_distributed(pg, cfg, axis)
    gp, cp = optimize_pcg(pg, cfg)
    torch.cuda.synchronize()
    calls, nbytes = axis.calls, axis.bytes
    _, syncs = count_syncs(lambda: optimize_distributed(pg, cfg, axis))
    return dict(same=all(torch.equal(a, b) for a, b in zip(g1, gp)) and torch.equal(c1, cp),
                calls=calls, bytes=nbytes, syncs=syncs, k=cfg.max_keyframes, gn=cfg.gn_iters,
                cg=cfg.cg_iters)


def card_slam_world_of_one(axis: MapAxis, cfg, frames_np, chunk: int) -> dict:
    """A ``ShardedSlamSystem`` on a world of one shard on the card against
    ``SlamSystem`` over ``frames_np`` in chunks of ``chunk``: whether the
    odometry, graph and state are bit-identical, and the host syncs of
    each sharded chunk."""
    from topfusion_tpu_torch.models.slam import SlamSystem
    from topfusion_tpu_torch.parallel import ShardedSlamSystem

    frames = torch.from_numpy(frames_np).to(axis.device)
    sh, ref = ShardedSlamSystem(cfg, axis), SlamSystem(cfg, device=axis.device)
    sh.warmup(chunk)
    syncs = []
    for c in range(len(frames) // chunk):
        part = frames[c * chunk:(c + 1) * chunk]
        _, s = count_syncs(lambda: sh.process_chunk(part))
        syncs.append(len(s))
        ref.process_chunk(part)
    return dict(
        odom=np.array_equal(np.stack(sh.odom_poses), np.stack(ref.odom_poses)),
        graph=all(torch.equal(a, b) for a, b in zip(sh.graph, ref.graph)),
        state=all(torch.equal(a, b) for a, b in zip(
            [*sh.state[:8], *sh.state.model_points, sh.state.vis_slots],
            [*ref.state[:8], *ref.state.model_points, ref.state.vis_slots])),
        ok=all(bool(np.all(np.isfinite(p))) for p in sh.odom_poses), syncs=syncs)


# ------------------------------------------------------ the stream pipeline
def tensor_digest(tree) -> dict:
    """sha256 of every tensor of a NamedTuple of tensors (per-level tuples
    by level), by field: to compare results across processes to the bit."""
    import hashlib

    out = {}
    for name, v in tree._asdict().items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            out[f"{name}[{i}]"] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def stream_numpy(state, reg) -> dict:
    """A process's state and register as numpy, the pools cut to their
    live rows (the rest is the empty value in both packages)."""
    from topfusion_tpu_torch.convert import _state_to_numpy

    st = block_state_to_numpy(state)
    n = int(st["num_blocks"])
    st["tsdf"], st["weight"] = st["tsdf"][:n], st["weight"][:n]
    return dict(state=st, reg=_state_to_numpy(reg))


def sparse_pools(state: dict, fill: dict) -> dict:
    """``state`` (numpy fields) with its pools ``tsdf`` and ``weight``
    stored as the rows that differ from ``fill[name]`` (index arrays over
    the leading dims and the rows): a JAX stream state at the test config
    is mostly empty pool, too large to hand to a world whole."""
    out = dict(state)
    for name, value in fill.items():
        a = np.asarray(state[name])
        rows = np.nonzero((a != value).reshape(a.shape[:2] + (-1,)).any(axis=-1))
        out[name] = ("sparse", a.shape, a.dtype, value, rows, a[rows])
    return out


def dense_pools(state: dict) -> dict:
    """The inverse of ``sparse_pools``."""
    out = dict(state)
    for name, v in state.items():
        if isinstance(v, tuple) and len(v) == 6 and isinstance(v[0], str) and v[0] == "sparse":
            _, shape, dtype, value, rows, vals = v
            a = np.full(shape, value, dtype=dtype)
            a[rows] = vals
            out[name] = a
    return out


def _stream_carried(pipe, frames, inputs) -> list:
    """Each frame stepped from the JAX state and register before it:
    this process's numpy state and register after it, and the link's and
    the map row's calls and bytes in the step."""
    from topfusion_tpu_torch.convert import stream_state_from_numpy

    mesh, out = pipe.mesh, []
    for f, (st_np, rg_np) in zip(frames, inputs):
        st, rg = stream_state_from_numpy(dense_pools(st_np), rg_np, mesh.stage, mesh.map.rank,
                                         mesh.n_map, "cpu")
        before = (mesh.link.calls, mesh.link.bytes, mesh.map.calls, mesh.map.bytes)
        st, rg = pipe.step(st, rg, f)
        after = (mesh.link.calls, mesh.link.bytes, mesh.map.calls, mesh.map.bytes)
        out.append(dict(stream_numpy(st, rg), traffic=[b - a for a, b in zip(before, after)]))
    return out


def stream_world(axis: MapAxis, inputs_path: str) -> dict:
    """Everything a stream-pipeline test checks, in one world of ``2 x
    n_map`` processes (``inputs["n_map"]``):

    * ``init``: this process's empty state and register;
    * ``carried`` / ``reset_carried``: the orbit's and the reset
      sequence's frames, each stepped from the JAX values before it;
    * ``free``: the orbit from ``init`` (poses, the last state and
      register, their digests); ``reset_free`` and ``fresh``: the reset
      sequence and its good frames alone from ``init`` (poses, counters,
      blocks);
    * ``broadcast``: ``MapAxis.broadcast`` over this process's pair group
      from member 1 and from member 0 (the default);
    * ``dryrun``: ``dryrun_stream_step`` on this world;
    * with ``n_map`` 1: ``run_stream`` on its default mesh, the mesh's
      refusals, and on rank 0 the digests of ``run_lockstep`` over the
      orbit in this process.
    """
    from topfusion_tpu_torch.parallel import (
        StreamBlockPipeline,
        dryrun_stream_step,
        make_pipe_mesh,
        run_stream,
    )
    from topfusion_tpu_torch.parallel.stream_pipeline import run_lockstep

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg, n_map = inp["cfg"], inp["n_map"]
    frames = [torch.from_numpy(f) for f in inp["frames"]]
    mesh = make_pipe_mesh(2, n_map, "cpu")
    pipe = StreamBlockPipeline(cfg, mesh, "cpu")
    st0, rg0 = pipe.init()
    out = dict(rank=axis.rank, stage=mesh.stage, map_rank=mesh.map.rank,
               local_cfg=pipe.local_cfg, init=stream_numpy(st0, rg0),
               init_pool=(tuple(st0.tsdf.shape), str(st0.tsdf.dtype)))
    out["carried"] = _stream_carried(pipe, frames, inp["jax_inputs"])

    st, rg, poses = pipe.run(st0, rg0, frames)
    out["free"] = dict(poses=poses.numpy(), last=stream_numpy(st, rg),
                       digest=tensor_digest(st), reg_digest=tensor_digest(rg))

    reset_frames = [torch.from_numpy(f) for f in inp["reset_frames"]]
    out["reset_carried"] = _stream_carried(pipe, reset_frames, inp["jax_reset_inputs"])
    st, rg, poses = pipe.run(st0, rg0, reset_frames)
    out["reset_free"] = dict(poses=poses.numpy(), resets=int(st.resets), frame=int(st.frame),
                             num_blocks=int(st.num_blocks))
    st, rg, poses = pipe.run(st0, rg0, reset_frames[: inp["n_good"]])
    out["fresh"] = dict(num_blocks=int(st.num_blocks))

    link = mesh.link
    mine = torch.full((3,), float(axis.rank))
    calls = link.calls
    out["broadcast"] = dict(from1=link.broadcast(mine, src=1).tolist(),
                            from0=link.broadcast(mine).tolist(), calls=link.calls - calls)

    dryrun_stream_step(2 * n_map, device="cpu")
    out["dryrun"] = True

    if n_map == 1:
        out["run_stream"] = run_stream(cfg, torch.stack(frames), device="cpu")
        refused = []
        for args in ((2, 2), (3, 1), (2, 0)):
            try:
                make_pipe_mesh(*args, device="cpu")
                refused.append(None)
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
        if axis.rank == 0:
            (s0, r0), (s1, r1), lposes = run_lockstep(cfg, frames, "cpu")
            out["lockstep"] = dict(stage0=tensor_digest(s0), reg0=tensor_digest(r0),
                                   stage1=tensor_digest(s1), reg1=tensor_digest(r1),
                                   poses=lposes.numpy())
    return out


def card_stream_world(axis: MapAxis, cfg, frames_np) -> dict:
    """A ``2 x 1`` stream world on the card: the frames from ``init``
    (digests of the final state and register, the poses, the integrate
    kernel's launches), then one more step under the sync counter and
    the link's counters."""
    from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
    from topfusion_tpu_torch.parallel import StreamBlockPipeline, make_pipe_mesh

    dev = axis.device
    mesh = make_pipe_mesh(2, 1, dev)
    pipe = StreamBlockPipeline(cfg, mesh, dev)
    frames = torch.from_numpy(np.stack(frames_np)).to(dev)
    torch.cuda.synchronize()
    integrate_blocks_cuda.launches = 0
    st, rg, poses = pipe.run(*pipe.init(), frames)
    torch.cuda.synchronize()
    out = dict(stage=mesh.stage, launches=integrate_blocks_cuda.launches,
               digest=tensor_digest(st), reg_digest=tensor_digest(rg),
               poses=poses.cpu().numpy())
    calls, nbytes = mesh.link.calls, mesh.link.bytes
    _, out["syncs"] = count_syncs(lambda: pipe.step(st, rg, frames[-1]))
    out["link"] = (mesh.link.calls - calls, mesh.link.bytes - nbytes)
    return out
