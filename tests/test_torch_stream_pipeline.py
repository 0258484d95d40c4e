"""The port's streaming pipeline (``parallel/stream_pipeline.py``) against
the JAX package's on the ``2 x 2`` pipe x map mesh: one gloo world of 4
CPU processes (stage ``r // 2``, map shard ``r % 2``) against one JAX
``StreamBlockPipeline`` on a mesh of 4 virtual CPU devices, at
tests/test_stream_pipeline.py's 80x64 config and scenarios.

The JAX pipeline runs in one-frame chunks (one compile), which gives its
state and register after every step.  Each step is also taken in the
world from the JAX values before it, carried into every process
(``convert.stream_state_from_numpy``): stage 1's keys, slots, coords and
live counts, the frame and reset counters, the register's flags and the
zeros of its unsourced fields must then equal the JAX package's exactly;
poses agree within 5e-6 m, the register's model maps within 1e-4 m on 99%
of the pixels both runs hold, the TSDF within 5e-4 on 99.9% of the live
pool (the rest of it is empty in both).  XLA contracts multiply-adds
that the port rounds apart and sums the composited splat in another
order, and the two-frame model lag compounds that, so the free run is
held to the JAX tests' own cross-mesh tolerances (2.5 mm, 1e-2) and
acceptance checks.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from torch_sharded_world import dense_pools, sparse_pools, stream_numpy, stream_world
from topfusion_tpu.config import tiny_test_config
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.ops.blockmap import EMPTY_KEY
from topfusion_tpu.parallel.stream_pipeline import StreamBlockPipeline as JaxStream
from topfusion_tpu.parallel.stream_pipeline import make_pipe_mesh as jax_pipe_mesh
from topfusion_tpu_torch.convert import (
    config_from_reference,
    stream_state_from_numpy,
    stream_state_to_numpy,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.parallel import spawn_world
from topfusion_tpu_torch.parallel.stream_pipeline import link_bytes

N_MAP = 2
N_FRAMES = 8  # tests/test_stream_pipeline.py's 2 x 2 orbit
N_GOOD = 4  # the reset sequence: 4 good frames, one all-zero frame, 4 good
POSE_TOL = 5e-6
TSDF_TOL = 5e-4
MAP_TOL = 1e-4
EXACT_STATE = ("bucket_keys", "bucket_slots", "block_coords", "num_blocks", "frame",
               "resets", "vis_slots")
EXACT_REG = ("valid", "reset", "maps_valid")
FWD = ("pose", "raw", "reset", "valid")
BWD = ("maps_p", "maps_n", "maps_pose", "maps_valid")


def jax_numpy(nt) -> dict:
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in nt._asdict().items()}


def orbit_frames(cfg, n: int, seed: int = 11):
    scene = SyntheticScene()
    gt = orbit_trajectory(n, max_angle_deg=3.0, max_shift=0.03, seed=seed)
    return gt, [np.array(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
                for T in gt]


def reset_frames(cfg):
    """tests/test_stream_pipeline.py:101-106: four frames at one pose, an
    all-zero frame, the four again."""
    good = np.array(SyntheticScene().render_depth_mm(cfg.camera, jnp.eye(4)))
    return [good] * N_GOOD + [np.zeros_like(good)] + [good] * N_GOOD


def jax_run(pipe, frames) -> dict:
    """The JAX pipeline over ``frames`` in one-frame chunks from ``init``:
    ``vals``, the (state, register) numpy before each step and after the
    last (pools stored sparse), and stage 0 map-shard 0's poses."""
    state, reg = pipe.init()
    tsdf0 = np.asarray(state.tsdf).reshape(-1)[0]
    fill = {"tsdf": tsdf0, "weight": np.zeros((), np.asarray(state.weight).dtype)}
    vals = [(sparse_pools(jax_numpy(state), fill), jax_numpy(reg))]
    poses = []
    for f in frames:
        state, reg, p = pipe.run(state, reg, jnp.asarray(f)[None])
        vals.append((sparse_pools(jax_numpy(state), fill), jax_numpy(reg)))
        poses.append(np.asarray(p)[0, 0, 0])
    return dict(vals=vals, poses=np.stack(poses))


def stream_fixture(n_map: int, n_frames: int, tmp_path_factory) -> dict:
    """One JAX pipeline on a ``2 x n_map`` mesh over the orbit, the reset
    sequence and its good frames; one gloo world of ``2 x n_map`` CPU
    processes over the same (``torch_sharded_world.stream_world``)."""
    cfg = tiny_test_config()
    gt, frames = orbit_frames(cfg, n_frames)
    rframes = reset_frames(cfg)
    pipe = JaxStream(cfg, jax_pipe_mesh(2, n_map=n_map))
    orbit, reset, fresh = jax_run(pipe, frames), jax_run(pipe, rframes), jax_run(pipe, rframes[:N_GOOD])
    inputs = dict(cfg=config_from_reference(cfg), n_map=n_map, frames=frames,
                  jax_inputs=orbit["vals"][:-1], reset_frames=rframes,
                  jax_reset_inputs=reset["vals"][:-1], n_good=N_GOOD)
    path = tmp_path_factory.mktemp("stream") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ranks = spawn_world(stream_world, 2 * n_map, "gloo", "cpu", args=(str(path),), threads=1,
                        timeout_s=600)
    return dict(cfg=cfg, gt=gt, frames=frames, n_map=n_map, ranks=ranks, orbit=orbit,
                reset=reset, fresh=fresh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return stream_fixture(N_MAP, N_FRAMES, tmp_path_factory)


# ----------------------------------------------------------------- checks
def local_expected(vals, rank: int, n_map: int) -> dict:
    """The JAX (state, register) ``vals`` of one step, local to world rank
    ``rank``, as ``stream_numpy`` gives the world's."""
    stage, mid = divmod(rank, n_map)
    st, rg = stream_state_from_numpy(dense_pools(vals[0]), vals[1], stage, mid, n_map, "cpu")
    return stream_numpy(st, rg)


def maps_close(got, want, what):
    """Model-map pyramids (levels of [h, w, 3]).  At level 0 the pixels
    either run holds are held by both on 99%, and are within MAP_TOL on
    99% of those.  A coarser pixel is made from a 2 x 2 block of the level
    above, so one pixel that differs spoils one pixel of each coarser
    level: the coarser levels may differ at no more pixels than level 0's
    allowance."""
    for level, (g, w) in enumerate(zip(got, want)):
        both = np.any(g != 0, axis=-1) & np.any(w != 0, axis=-1)
        either = np.any(g != 0, axis=-1) | np.any(w != 0, axis=-1)
        if level == 0:
            one_only, off_tol = 0.01 * either.sum(), 0.01 * both.sum()
        err = np.abs(g[both] - w[both]).max(axis=-1)
        assert (either & ~both).sum() <= one_only, (what, level, both.sum(), either.sum())
        assert (err > MAP_TOL).sum() <= off_tol, (what, level, (err > MAP_TOL).sum(), err.max())


def assert_step_matches(got_ranks, vals, n_map: int, what: str):
    """Every process's (state, register) after a carried step against the
    JAX values ``vals`` after it."""
    for r, got in enumerate(got_ranks):
        want = local_expected(vals, r, n_map)
        stage = r // n_map
        gs, ws, gr, wr = got["state"], want["state"], got["reg"], want["reg"]
        tag = f"{what} rank {r}"
        for name in EXACT_STATE:
            np.testing.assert_array_equal(gs[name], ws[name], err_msg=f"{tag} {name}")
        np.testing.assert_allclose(gs["T_wc"], ws["T_wc"], rtol=0, atol=POSE_TOL, err_msg=tag)
        t_off = np.abs(gs["tsdf"] - ws["tsdf"]) > TSDF_TOL
        assert not t_off.size or t_off.mean() <= 1e-3, (tag, t_off.mean())
        w_off = gs["weight"] != ws["weight"]
        assert not w_off.size or w_off.mean() <= 1e-3, (tag, w_off.mean())
        for key in ("model_points", "model_normals"):
            maps_close(gs[key], ws[key], f"{tag} {key}")
        for name in EXACT_REG:
            np.testing.assert_array_equal(gr[name], wr[name], err_msg=f"{tag} reg.{name}")
        # What this process sent comes back as zeros, in both packages.
        for name in (FWD if stage == 0 else BWD):
            for g, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (gr[name], wr[name]))):
                assert not np.any(g) and not np.any(w), f"{tag} reg.{name} not zeroed"
        if stage == 1:
            np.testing.assert_allclose(gr["pose"], wr["pose"], rtol=0, atol=POSE_TOL, err_msg=tag)
            np.testing.assert_array_equal(gr["raw"], wr["raw"], err_msg=f"{tag} reg.raw")
        else:
            np.testing.assert_allclose(gr["maps_pose"], wr["maps_pose"], rtol=0, atol=POSE_TOL,
                                       err_msg=tag)
            for key in ("maps_p", "maps_n"):
                maps_close(gr[key], wr[key], f"{tag} reg.{key}")


def assert_world_traffic(world):
    """Per step and process: two broadcasts on the link, the forward and
    the backward buffer; on stage 1 with more than one shard the row's
    two candidate gathers, the key image's pmin and the attribute image's
    psum; nothing on stage 0's row."""
    cfg, n_map = world["cfg"], world["n_map"]
    cam, bm = cfg.camera, cfg.blockmap
    strip = (cam.height // bm.alloc_pixel_stride // n_map) * (cam.width // bm.alloc_pixel_stride)
    pixels = cam.height * cam.width
    row_bytes = strip * bm.alloc_steps * (3 * 4 + 1) + pixels * 4 + pixels * 5 * 4
    fwd, bwd = link_bytes(config_from_reference(cfg))
    for out in world["ranks"]:
        for step in out["carried"]:
            calls, nbytes, row_calls, row_b = step["traffic"]
            assert (calls, nbytes) == (2, fwd + bwd)
            if out["stage"] == 1 and n_map > 1:
                assert (row_calls, row_b) == (4, row_bytes)
            else:
                assert (row_calls, row_b) == (0, 0)


def assert_free_run(world, t_tol=2.5e-3, r_tol=1e-2):
    """Stage 0's free-running poses against the JAX run's, every stage-0
    replica bit-identical, no block on two stage-1 shards."""
    n_map, ranks = world["n_map"], world["ranks"]
    want = world["orbit"]["poses"]
    stage0 = [o for o in ranks if o["stage"] == 0]
    for o in stage0:
        np.testing.assert_array_equal(o["free"]["poses"], stage0[0]["free"]["poses"])
    got = stage0[0]["free"]["poses"]
    assert np.isfinite(got).all()
    assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() < t_tol
    assert np.abs(got[:, :3, :3] - want[:, :3, :3]).max() < r_tol
    stage1 = [o["free"]["last"]["state"] for o in ranks if o["stage"] == 1]
    keys = np.concatenate([s["bucket_keys"].reshape(-1) for s in stage1])
    live = keys[keys != EMPTY_KEY]
    assert len(np.unique(live)) == len(live) == sum(int(s["num_blocks"]) for s in stage1)
    assert len(live) > 0
    return got


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("rank", range(2 * N_MAP))
def test_init_is_the_jax_slice(world, rank):
    got, want = world["ranks"][rank]["init"], local_expected(world["orbit"]["vals"][0], rank, N_MAP)
    for part in ("state", "reg"):
        assert got[part].keys() == want[part].keys()
        for name in got[part]:
            g, w = got[part][name], want[part][name]
            for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (g, w))):
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{name}")
                assert a.dtype == b.dtype and a.shape == b.shape, name
    assert world["ranks"][rank]["init_pool"][0][0] == tiny_test_config().blockmap.capacity // N_MAP + 1


def test_ranks_and_local_config(world):
    """Rank r is stage r // n_map and map shard r % n_map (the JAX mesh's
    row-major order); every process holds the JAX ``_shard_cfg``."""
    from topfusion_tpu.parallel.block_sharded import _shard_cfg

    want = config_from_reference(_shard_cfg(tiny_test_config(), N_MAP))
    for r, out in enumerate(world["ranks"]):
        assert (out["stage"], out["map_rank"]) == divmod(r, N_MAP)
        assert out["local_cfg"] == want


@pytest.mark.parametrize("step", range(N_FRAMES))
def test_carried_step_matches_jax(world, step):
    got = [out["carried"][step] for out in world["ranks"]]
    assert_step_matches(got, world["orbit"]["vals"][step + 1], N_MAP, f"step {step}")


def test_link_and_row_traffic(world):
    assert_world_traffic(world)


def test_free_run_follows_jax(world):
    """The free-running trajectory within the JAX tests' 2.5 mm and 1e-2
    of the JAX run on the same mesh (tests/test_stream_pipeline.py:85-91),
    the replicas bit-identical, and within 3 voxels of the truth
    (tests/test_stream_pipeline.py:63)."""
    got = assert_free_run(world)
    assert ate_rmse(list(got), list(world["gt"]), align=False) < 3 * world["cfg"].tsdf.voxel_size


def test_free_run_block_count(world):
    """Ownership puts every block on one shard; the total within 5% of
    the JAX run's."""
    stage1 = [o["free"]["last"]["state"] for o in world["ranks"] if o["stage"] == 1]
    total = sum(int(s["num_blocks"]) for s in stage1)
    n_jax = int(dense_pools(world["orbit"]["vals"][-1][0])["num_blocks"][1].sum())
    assert abs(total - n_jax) <= max(16, 0.05 * n_jax), (total, n_jax)


@pytest.mark.parametrize("step", range(2 * N_GOOD + 1))
def test_reset_sequence_carried(world, step):
    """The garbage-frame sequence, each step from the JAX values before
    it: the reset travels the register and every count equals the JAX
    package's."""
    got = [out["reset_carried"][step] for out in world["ranks"]]
    assert_step_matches(got, world["reset"]["vals"][step + 1], N_MAP, f"reset step {step}")


def test_reset_sequence_free(world):
    """tests/test_stream_pipeline.py:111-127 on the port: stage 0 resets,
    the last pose re-bootstraps at identity, and stage 1's map was wiped
    (no more blocks than 1.25 x a fresh run over the good frames)."""
    ranks, n_map = world["ranks"], world["n_map"]
    for o in ranks:
        assert np.isfinite(o["reset_free"]["poses"]).all()
    s0 = ranks[0]["reset_free"]
    assert s0["resets"] >= 1
    assert np.abs(s0["poses"][-1] - np.eye(4)).max() < 0.05
    n_after = sum(o["reset_free"]["num_blocks"] for o in ranks[n_map:])
    n_ref = sum(o["fresh"]["num_blocks"] for o in ranks[n_map:])
    assert 0 < n_after <= 1.25 * n_ref, (n_after, n_ref)


def test_global_layout_round_trip(world):
    """The JAX global arrays after the orbit, sliced to every process and
    put back together (``convert.stream_state_to_numpy``), are the same
    arrays: shapes, dtypes and values; replicas that differ are refused."""
    st_np, rg_np = world["orbit"]["vals"][-1]
    st_np = dense_pools(st_np)
    n_map = world["n_map"]
    parts = [stream_state_from_numpy(st_np, rg_np, r // n_map, r % n_map, n_map, "cpu")
             for r in range(2 * n_map)]
    state, reg = stream_state_to_numpy(parts)
    for got, want in ((state, st_np), (reg, rg_np)):
        assert got.keys() == want.keys()
        for name in want:
            for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (got[name], want[name]))):
                assert a.shape == b.shape and a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    if n_map > 1:
        bad = parts[1][0]._replace(T_wc=parts[1][0].T_wc + 1.0)
        with pytest.raises(ValueError, match="T_wc of map shard 1"):
            stream_state_to_numpy([parts[0], (bad, parts[1][1])] + parts[2:])


def test_broadcast_from_member_one_of_a_pair(world):
    """``MapAxis.broadcast(src=1)`` over the pair group {j, n_map + j} of a
    world of 4 delivers the stage-1 member's tensor; the default delivers
    member 0's; each counts one call."""
    n_map = world["n_map"]
    for out in world["ranks"]:
        j = out["map_rank"]
        assert out["broadcast"]["from1"] == [float(n_map + j)] * 3
        assert out["broadcast"]["from0"] == [float(j)] * 3
        assert out["broadcast"]["calls"] == 2


def test_dryrun_hook(world):
    assert all(out["dryrun"] for out in world["ranks"])
