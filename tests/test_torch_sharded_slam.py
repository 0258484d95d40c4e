"""The port's composed sharded SLAM system (``parallel/sharded_slam.py``)
and ``ShardedHostCache.remap_store`` against the JAX package's: one gloo
world of 4 CPU processes against one JAX ``ShardedSlamSystem`` on a mesh
of 4 virtual CPU devices, at tests/test_sharded_slam.py's 80x64 config
with an 8-frame re-integration ring and every correction rebuilding the
map, over a 15-frame out-and-back in chunks of 3 that closes a loop.

How the runs are compared.  Summation orders differ between the packages
(gloo's ring against XLA's all-reduce, matmuls against scatter-adds) and
XLA contracts multiply-adds that the port rounds apart, and a free run
amplifies the difference.  So each chunk is also processed from the JAX
system's values before it, carried into every shard
(``convert.sharded_slam_state_from_numpy``): every shard's local keys,
slots, coords and live count, the frame counters, the keyframe and loop
bookkeeping and the infos' flags must then equal the JAX package's
exactly; poses, the graph's keyframe poses and the buffers' poses agree
within 1e-4 m (the JAX package's own tolerance between a mesh and one
device, tests/test_parallel.py:56).  The free run is held to the JAX
free run's acceptance checks (tests/test_sharded_slam.py:100-118: the
same keyframes, closures and edges as the JAX run, odometry within 2 mm
of it, optimized ATE under 2 cm, blocks on more than one shard), and the
shards' trajectories, graphs and model maps are bit-identical.

``remap_store`` runs on every shard's store made from a seed, with a 45
degree yaw so that blocks both collide and change shard: each shard's
new store must equal the JAX ``stores[r]`` in its keys, their order and
the payloads' bits and dtypes.
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_sharded_slam import make_cfg, out_and_back
from torch_sharded_world import slam_world
from topfusion_tpu.io.synthetic import SyntheticScene
from topfusion_tpu.io.trajectory import ate_rmse
from topfusion_tpu.models.host_cache import ShardedHostCache as JaxShardedCache
from topfusion_tpu.parallel.block_sharded import _shard_cfg as jax_shard_cfg
from topfusion_tpu.parallel.block_sharded import make_mesh as jax_make_mesh
from topfusion_tpu.parallel.sharded_slam import ShardedSlamSystem as JaxShardedSlam
from topfusion_tpu_torch.convert import (
    config_from_reference,
    gather_sharded_slam_state,
    sharded_block_state_from_numpy,
    block_state_to_numpy,
    sharded_slam_state_to_numpy,
)
from topfusion_tpu_torch.ops.blockmap import EMPTY_KEY
from topfusion_tpu_torch.parallel import spawn_world

NS = 4
FRAMES, CHUNK = 15, 3
SAVE_AT = 2  # chunks before the checkpoint
POSE_TOL = 1e-4
MAP_FIELDS = ("bucket_keys", "bucket_slots", "block_coords", "num_blocks")
INFO_FLAGS = ("frame", "ok", "reset", "blocks", "dropped", "visible_overflow", "loop")
REMAP_BLOCKS = 300  # per shard


def slam_cfg():
    cfg = make_cfg()
    return dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, reint_ring=8, min_map_correction=0.0))


def remap_case(pool: str, seed: int) -> dict:
    """Every shard's store of REMAP_BLOCKS blocks it owns (seeded keys in a
    40-block cube, payloads in the pool dtype), a 45 degree yaw about the
    cube's centre with a shift, and the JAX stores after ``remap_store``."""
    cfg = slam_cfg()
    cfg = dataclasses.replace(cfg, blockmap=dataclasses.replace(cfg.blockmap, pool_dtype=pool))
    lc = jax_shard_cfg(cfg, NS)
    dt = np.int16 if pool == "int16" else np.float32
    rng = np.random.default_rng(seed)
    nb_global = lc.blockmap.capacity * NS
    stores = [dict() for _ in range(NS)]
    b = cfg.blockmap.block_size
    while min(len(s) for s in stores) < REMAP_BLOCKS:
        k = rng.integers(-20, 20, size=3)
        h = (k[0] * 73856093) ^ (k[1] * 19349669) ^ (k[2] * 83492791)
        owner = int((h & (nb_global - 1)) % NS)
        key = tuple(int(x) for x in k)
        if len(stores[owner]) < REMAP_BLOCKS and key not in stores[owner]:
            if dt == np.int16:
                t = rng.integers(-32767, 32767, size=(b, b, b)).astype(dt)
                w = rng.integers(0, 2000, size=(b, b, b)).astype(dt)
            else:
                t = rng.uniform(-1, 1, size=(b, b, b)).astype(dt)
                w = rng.uniform(0, 60, size=(b, b, b)).astype(dt)
            stores[owner][key] = (t, w, None)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    corr = np.array([[c, 0, s, 0.013], [0, 1, 0, -0.021], [-s, 0, c, 0.007], [0, 0, 0, 1]],
                    np.float64)
    jc = JaxShardedCache.__new__(JaxShardedCache)
    jc.bm_cfg, jc.tsdf_cfg, jc.ns = lc.blockmap, lc.tsdf, NS
    jc.stores = [dict(st) for st in stores]
    jc.remap_store(corr)
    return dict(cfg=config_from_reference(cfg), corr=corr, stores=stores, want=jc.stores)


def jax_run(cfg, frames):
    """The JAX system over the chunks: its values before and after each,
    and each chunk's infos."""
    slam = JaxShardedSlam(cfg, jax_make_mesh(NS))
    before, after, infos = [], [], []
    for c in range(FRAMES // CHUNK):
        before.append(sharded_slam_state_to_numpy(slam))
        infos.append(slam.process_chunk(np.stack(frames[c * CHUNK:(c + 1) * CHUNK]), do_kf=True))
        after.append(sharded_slam_state_to_numpy(slam))
    return slam, before, after, infos


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = slam_cfg()
    scene = SyntheticScene()
    gt = out_and_back(FRAMES)
    frames = [np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in gt]
    slam, before, after, infos = jax_run(cfg, frames)
    remap = {"int16": remap_case("int16", 5), "float32": remap_case("float32", 6)}
    tmp = tmp_path_factory.mktemp("sharded_slam")
    inputs = dict(cfg=config_from_reference(cfg), frames=np.stack(frames), chunk=CHUNK,
                  before=before, save_at=SAVE_AT, ckpt=str(tmp / "composed"),
                  remap={k: {n: v for n, v in case.items() if n != "want"}
                         for k, case in remap.items()})
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ranks = spawn_world(slam_world, NS, "gloo", "cpu", args=(str(path),), threads=1,
                        timeout_s=600)
    return dict(gt=[np.asarray(T) for T in gt], ranks=ranks, after=after, infos=infos,
                jax_odom=np.stack(slam.odom_poses), jax_loops=slam.loops_closed,
                jax_reint=slam.reintegrations, jax_num_kf=int(slam.graph.num_kf),
                jax_num_edges=int(slam.graph.num_edges), remap=remap)


def local(arrays, rank) -> dict:
    return block_state_to_numpy(sharded_block_state_from_numpy(arrays, rank, NS, device="cpu"))


def test_premise_the_run_closes_a_loop_and_rebuilds(world):
    assert world["jax_loops"] >= 1 and world["jax_reint"] >= 1
    assert any(i["loop"] for chunk in world["infos"] for i in chunk)


@pytest.mark.parametrize("chunk", range(FRAMES // CHUNK))
def test_carried_chunk_matches_jax(world, chunk):
    want = world["after"][chunk]
    for r, rank in enumerate(world["ranks"]):
        got = rank["carried"][chunk]
        gv = got["values"]
        exp = local(want["state"], r)
        for name in MAP_FIELDS + ("frame", "resets"):
            np.testing.assert_array_equal(gv["state"][name], exp[name],
                                          err_msg=f"chunk {chunk} rank {r} {name}")
        np.testing.assert_allclose(gv["state"]["T_wc"], exp["T_wc"], rtol=0, atol=POSE_TOL)
        for name in ("num_kf", "num_edges", "edge_i", "edge_j", "edge_is_loop", "kf_frame"):
            np.testing.assert_array_equal(gv["graph"][name], want["graph"][name], err_msg=name)
        np.testing.assert_allclose(gv["graph"]["kf_poses"], want["graph"]["kf_poses"],
                                   rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(gv["kf_odom_buf"], want["kf_odom_buf"], rtol=0, atol=POSE_TOL)
        np.testing.assert_array_equal(gv["kf_depth_buf"], want["kf_depth_buf"])
        for a, b in zip(gv["ring"], want["ring"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)
        for name in ("kf_for_frame", "frame_idx", "loops_closed", "reintegrations"):
            assert gv[name] == want[name], (chunk, r, name)
        np.testing.assert_allclose(np.stack(gv["odom_poses"]), np.stack(want["odom_poses"]),
                                   rtol=0, atol=POSE_TOL)
        for gi, wi in zip(got["infos"], world["infos"][chunk]):
            for name in INFO_FLAGS:
                assert gi[name] == wi[name], (chunk, r, name, gi[name], wi[name])
            assert gi.get("reintegrated", False) == wi.get("reintegrated", False)
            assert gi.get("loop_closures") == wi.get("loop_closures")


def test_carried_chunks_round_trip_the_global_layout(world):
    """The shards' values put back together have the JAX system's global
    map layout."""
    for chunk in range(FRAMES // CHUNK):
        got = gather_sharded_slam_state([r["carried"][chunk]["values"] for r in world["ranks"]])
        want = world["after"][chunk]
        for name in MAP_FIELDS:
            np.testing.assert_array_equal(got["state"][name], want["state"][name])
            assert got["state"][name].dtype == want["state"][name].dtype


def test_decisions_cost_one_broadcast_per_chunk(world):
    """A chunk without a closure issues its steps' collectives and one
    broadcast of the packed fetch; a closure adds the solve's sums, the
    solve's broadcast and the rebuild's collectives, the same on every
    shard."""
    for chunk in range(FRAMES // CHUNK):
        calls = [r["carried"][chunk]["calls"] for r in world["ranks"]]
        assert len(set(calls)) == 1, calls
    cfg = slam_cfg()
    steps = CHUNK * (sum(cfg.icp.iters) + 5)
    quiet = [c for c in range(FRAMES // CHUNK) if not any(i["loop"] for i in world["infos"][c])]
    assert quiet
    for c in quiet:
        assert world["ranks"][0]["carried"][c]["calls"] == steps + 1


def test_free_run_acceptance(world):
    """tests/test_sharded_slam.py:100-118 on the port's free run: every
    frame tracked, the JAX run's keyframes, closures and edges, odometry
    within 2 mm of it, optimized ATE under 2 cm, blocks on several shards;
    and the shards agree bit for bit."""
    r0 = world["ranks"][0]["free"]
    assert all(i["ok"] for i in r0["infos"])
    assert int(r0["values"]["graph"]["num_kf"]) == world["jax_num_kf"] == 5
    assert r0["loops"] == world["jax_loops"] >= 1
    assert int(r0["values"]["graph"]["num_edges"]) == world["jax_num_edges"]
    assert ate_rmse(list(r0["odom"]), list(world["jax_odom"]), align=False) < 2e-3
    assert ate_rmse(list(r0["opt"]), world["gt"], align=False) < 0.02
    per_shard = [int(r["free"]["values"]["state"]["num_blocks"]) for r in world["ranks"]]
    assert sum(n > 0 for n in per_shard) >= 2
    for r in world["ranks"][1:]:
        f = r["free"]
        np.testing.assert_array_equal(f["odom"], r0["odom"])
        np.testing.assert_array_equal(f["opt"], r0["opt"])
        np.testing.assert_array_equal(f["values"]["graph"]["kf_poses"],
                                      r0["values"]["graph"]["kf_poses"])
        for a, b in zip(f["values"]["state"]["model_points"], r0["values"]["state"]["model_points"]):
            np.testing.assert_array_equal(a, b)


def test_free_run_no_key_on_two_shards(world):
    keys = np.concatenate([r["free"]["values"]["state"]["bucket_keys"].reshape(-1)
                           for r in world["ranks"]])
    live = keys[keys != EMPTY_KEY]
    assert len(np.unique(live)) == len(live)
    assert len(live) == sum(int(r["free"]["values"]["state"]["num_blocks"]) for r in world["ranks"])


def test_checkpoint_resumes_bit_exactly(world):
    """The composed checkpoint after two chunks, restored into a fresh
    system that runs the rest: odometry, graph, map and counters
    bit-identical to the uninterrupted run, on every shard."""
    for r in world["ranks"]:
        assert r["resumed"]["at"] == SAVE_AT * CHUNK
        assert r["resumed"]["same"]


def test_mixed_epoch_restore_raises(world):
    """Shard 1's map from a later save than the others': every shard
    raises (none restores and goes on to wait in a collective)."""
    for r in world["ranks"]:
        assert r["mixed"] is not None and "restored frames" in r["mixed"], r["mixed"]


@pytest.mark.parametrize("pool", ["int16", "float32"])
def test_remap_store_matches_jax(world, pool):
    case = world["remap"][pool]
    stats = [r["remap"][pool]["stats"] for r in world["ranks"]]
    assert all(s == stats[0] for s in stats)
    # The premise: the yaw re-keys blocks onto other shards and merges some.
    assert stats[0]["reowned"] > 0 and stats[0]["merged"] > 0
    assert stats[0]["entries"] == NS * REMAP_BLOCKS
    for r, rank in enumerate(world["ranks"]):
        got, want = rank["remap"][pool], case["want"][r]
        assert got["calls"] == 1
        assert got["keys"] == list(want.keys()), r
        for g, w in zip(got["payloads"], want.values()):
            for a, b in zip(g, w):
                if b is None:
                    assert a is None
                    continue
                b = np.asarray(b)
                assert a.dtype == b.dtype, (r, a.dtype, b.dtype)
                np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert sum(len(w) for w in case["want"]) == NS * REMAP_BLOCKS - stats[0]["merged"]
