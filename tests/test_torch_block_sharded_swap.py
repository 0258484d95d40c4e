"""The sharded out-of-core sweep: tests/test_swap.py's sharded acceptance
test (``test_sharded_sweep_beyond_aggregate_capacity_matches_uncapped``)
on the port, in one gloo world of 4 CPU processes with a
``ShardedHostCache`` on every shard, and the port's cache against the
JAX package's on the same frames.

The corridor is tests/test_torch_swap.py's cut of the JAX test's, 20
frames out and 19 back: at 80x64 a free-running tracker slips by
centimetres on the JAX sweep's 16th frame, and free runs of the two
packages drift apart by millimetres (tests/test_torch_swap.py's module
docstring).  So the port's free runs are held to the JAX test's own
criteria: the scene's blocks exceed 1.2 x the aggregate capped pool, no
block is dropped, the overflow lives on the shards' hosts, live + host
blocks cover 95% of the scene, blocks come back on the return leg, and
the trajectory error is that of the uncapped sharded run (x 1.2 +
0.2 mm).

And the JAX ``ShardedBlockPipeline`` with its ``ShardedHostCache`` sweeps
the same capped corridor on a mesh of 4; before each frame of
``CARRIED`` its state and each shard's store, recency and clock are
carried into that shard's process, which restores, steps and evicts.  The
JAX cache runs one evict round over all shards, a shard with nothing to
evict padded with -1 (its table rebuilt unchanged), and one insert over
all shards; the port's shards evict and restore alone.  Each shard must
evict the same slots in the same rounds, restore the same mask, keep the
same store keys in the same order and the same recency, and leave the
same hash table, coords, live count and visible list; poses and pools
within tests/test_torch_swap.py's sweep tolerances.  ``CARRIED`` picks
frames of every kind the sweep has: one shard evicting alone (2), one
shard restoring one block (7), three shards restoring (16), the return
leg's first uneven restores (21), and full restore-and-evict frames (27,
35, 38).
"""

import dataclasses
import pickle

import numpy as np
import pytest

import jax.numpy as jnp

from tests.test_torch_swap import sweep_cfg, sweep_frames
from torch_sharded_world import sweep_world
from topfusion_tpu.models.host_cache import ShardedHostCache as JaxShardedCache
from topfusion_tpu.parallel.block_sharded import ShardedBlockPipeline as JaxSharded
from topfusion_tpu.parallel.block_sharded import make_mesh as jax_make_mesh
from topfusion_tpu_torch.convert import (
    block_state_to_numpy,
    config_from_reference,
    sharded_block_state_from_numpy,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.parallel import spawn_world

NS = 4
FWD = 20
CAP = 1 << 11             # aggregate capped pool: 512 slots per shard
EVICT, RESTORE = 128, 64  # per shard, as the JAX sharded test
CARRIED = (2, 7, 16, 21, 27, 35, 38)
MAP_FIELDS = ("bucket_keys", "bucket_slots", "block_coords", "num_blocks", "vis_slots")
COUNTS = ("num_blocks", "blocks_allocated", "num_visible", "blocks_dropped")


def jax_numpy(state) -> dict:
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


def local(arrays, rank) -> dict:
    """Shard ``rank``'s slice of a JAX global state, as the port's numpy."""
    return block_state_to_numpy(sharded_block_state_from_numpy(arrays, rank, NS, device="cpu"))


def jax_capped_sweep(cfg, frames):
    """The JAX capped sweep with its ``ShardedHostCache``.  For each frame
    of ``CARRIED``: what is carried into the port before it (``pre``:
    per shard the local state, the store, the recency; the cache's clock
    and the pose the restore reads) and what the frame did (``post``: the
    evict rounds' slots and the inserts' valid and restored masks, all
    shards'; per shard the store's keys and the recency; the global state
    after the eviction and the step's aux)."""
    pipe = JaxSharded(cfg, jax_make_mesh(NS))
    cache = JaxShardedCache(pipe, evict_batch=EVICT, restore_batch=RESTORE)
    evicts, inserts = [], []
    swap_evict, swap_insert = pipe.swap_evict, pipe.swap_insert

    def record_evict(state, slots):
        evicts.append(np.asarray(slots))
        return swap_evict(state, slots)

    def record_insert(state, blocks):
        state, ok = swap_insert(state, blocks)
        inserts.append((np.asarray(blocks.valid), np.asarray(ok)))
        return state, ok

    pipe.swap_evict, pipe.swap_insert = record_evict, record_insert
    state, T_prev, rows = pipe.init(), np.eye(4, dtype=np.float32), []
    for i, f in enumerate(frames):
        evicts.clear()
        inserts.clear()
        if i in CARRIED:
            arrays = jax_numpy(state)
            pre = dict(frame=i, T_prev=T_prev, clock=cache._frame, shards=[
                dict(state=local(arrays, r), store=dict(cache.stores[r]),
                     last_seen=cache.last_seen[r].copy()) for r in range(NS)])
        state = cache.before_step(state, T_prev)
        state, aux = pipe.step(state, jnp.asarray(f))
        T_prev = np.asarray(state.T_wc)
        state = cache.after_step(state)
        if i in CARRIED:
            rows.append(dict(pre=pre, post=dict(
                evicts=list(evicts), inserts=list(inserts),
                keys=[list(st.keys()) for st in cache.stores],
                last_seen=cache.last_seen.copy(), state=jax_numpy(state),
                aux={k: np.asarray(v) for k, v in aux._asdict().items()})))
    return rows


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    gt, frames = sweep_frames(FWD, sway_of=72)
    small = sweep_cfg(CAP)
    small = dataclasses.replace(small, blockmap=dataclasses.replace(
        small.blockmap, max_new_blocks_per_frame=1024))
    jax_rows = jax_capped_sweep(small, frames)
    tmp = tmp_path_factory.mktemp("sharded_sweep")
    carried_paths = []
    for r in range(NS):
        carried_paths.append(str(tmp / f"carried-{r}.pkl"))
        with open(carried_paths[-1], "wb") as f:
            pickle.dump([dict(frame=row["pre"]["frame"], T_prev=row["pre"]["T_prev"],
                              clock=row["pre"]["clock"], **row["pre"]["shards"][r])
                         for row in jax_rows], f)
    inputs = dict(frames=frames, cfg_big=config_from_reference(sweep_cfg(1 << 13)),
                  cfg_small=config_from_reference(small),
                  evict_batch=EVICT, restore_batch=RESTORE, carried_paths=carried_paths)
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ranks = spawn_world(sweep_world, NS, "gloo", "cpu",
                        args=(str(path),), threads=1, timeout_s=600)
    for row in jax_rows:
        del row["pre"]
    return dict(gt=gt, ranks=ranks, jax=jax_rows)


def totals(sweep, run):
    return sum(r[run]["live"] for r in sweep["ranks"])


def test_premise_scene_exceeds_the_capped_pool(sweep):
    assert totals(sweep, "uncapped") > 1.2 * CAP


@pytest.mark.parametrize("run", ["uncapped", "capped"])
def test_every_frame_tracked_on_every_shard(sweep, run):
    for r in sweep["ranks"]:
        assert all(bool(a["ok"]) for a in r[run]["aux"])
        assert not any(bool(a["was_reset"]) for a in r[run]["aux"])
        assert r[run]["vis_ok"]
    for r in sweep["ranks"][1:]:
        np.testing.assert_array_equal(np.stack(r[run]["poses"]),
                                      np.stack(sweep["ranks"][0][run]["poses"]))


def test_no_block_dropped_and_overflow_on_the_hosts(sweep):
    capped = [r["capped"] for r in sweep["ranks"]]
    assert sum(int(a["blocks_dropped"]) for a in capped[0]["aux"]) == 0
    host = sum(c["host"] for c in capped)
    assert host > 0
    assert totals(sweep, "capped") + host >= int(0.95 * totals(sweep, "uncapped"))
    # Each shard swaps its own blocks: at most its own capacity is live.
    assert all(c["live"] <= CAP // NS for c in capped)


def test_blocks_come_back_on_the_return_leg(sweep):
    capped = [r["capped"] for r in sweep["ranks"]]
    assert sum(sum(c["evicted"]) for c in capped) > 0
    assert sum(sum(c["restored"][FWD:]) for c in capped) > 0


def test_ate_matches_the_uncapped_run(sweep):
    r0 = sweep["ranks"][0]
    ate_ref = ate_rmse(r0["uncapped"]["poses"], sweep["gt"], align=False)
    ate = ate_rmse(r0["capped"]["poses"], sweep["gt"], align=False)
    assert ate <= 1.2 * ate_ref + 2e-4, (ate, ate_ref)


def test_shards_agree_on_the_model_maps(sweep):
    maps = [r["capped"]["model_points"] for r in sweep["ranks"]]
    for m in maps[1:]:
        np.testing.assert_array_equal(m, maps[0])


def test_carried_frames_cover_every_kind_of_swap(sweep):
    """The premise of the comparison below: among the carried frames, a
    JAX evict round where a shard has nothing to evict while another
    evicts, an insert where a shard restores nothing while another does,
    and frames where every shard restores."""
    rounds = [(e >= 0).any(axis=1) for row in sweep["jax"] for e in row["post"]["evicts"]]
    assert any(has.any() and not has.all() for has in rounds)
    inserts = [ok for row in sweep["jax"] for _, ok in row["post"]["inserts"]]
    assert any(ok.any(axis=1).any() and not ok.any(axis=1).all() for ok in inserts)
    assert any(ok.any(axis=1).all() for ok in inserts)


@pytest.mark.parametrize("k", range(len(CARRIED)), ids=[f"frame{f}" for f in CARRIED])
def test_carried_frame_swaps_as_jax(sweep, k):
    """One frame from the JAX state and cache, on every shard: the evict
    rounds in which the JAX cache gave this shard slots, with those slots
    (the rounds padded whole with -1 are the ones the port's shard skips);
    the restored mask of the JAX insert wherever this shard had blocks in
    it (none where it had none); the store's keys in order and the
    recency; the map fields exactly, the pose within 0.25 mm and the pools
    within tests/test_torch_swap.py's sweep tolerances."""
    row = sweep["jax"][k]["post"]
    for r, rank in enumerate(sweep["ranks"]):
        got = rank["carried"][k]
        assert got["frame"] == CARRIED[k]
        want_evicts = [e[r] for e in row["evicts"] if (e[r] >= 0).any()]
        assert len(got["evicts"]) == len(want_evicts), (r, len(got["evicts"]), len(want_evicts))
        for g, w in zip(got["evicts"], want_evicts):
            np.testing.assert_array_equal(g, w)
        want_inserts = [ok[r] for valid, ok in row["inserts"] if valid[r].any()]
        assert len(got["inserts"]) == len(want_inserts), r
        for g, w in zip(got["inserts"], want_inserts):
            np.testing.assert_array_equal(g, w)
        assert got["keys"] == row["keys"][r], r
        np.testing.assert_array_equal(got["last_seen"], row["last_seen"][r])

        exp, st = local(row["state"], r), got["state"]
        for name in MAP_FIELDS:
            np.testing.assert_array_equal(st[name], exp[name], err_msg=f"rank {r} {name}")
        gap = np.abs(st["T_wc"][:3] - exp["T_wc"][:3]).max()
        assert gap <= 2.5e-4, (r, gap)
        tol = max(5e-5, 10.0 * gap / 0.04)
        assert (np.abs(st["tsdf"] - exp["tsdf"]) > tol).mean() <= 1e-3, r
        assert (st["weight"] != exp["weight"]).mean() <= 1e-3, r
        for name in COUNTS:
            assert int(got["aux"][name]) == int(row["aux"][name]), (r, name)
        assert bool(got["aux"]["ok"]) and bool(row["aux"]["ok"])
