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
