"""The port's sharded block map against the JAX package's
``ShardedBlockPipeline``: one gloo world of 4 CPU processes (the port,
``parallel/launch.spawn_world``) against one JAX run on a mesh of 4
virtual CPU devices, at tests/test_block_sharded.py's 80x64 config over
its 6-frame orbit.

How the runs are compared.  The two packages sum ICP's Gram matrix over
the shards in another order (gloo's ring against XLA's all-reduce) and
XLA contracts multiply-adds that the port rounds apart, so poses differ
in the last bits and free runs drift apart by micrometres.  So each
frame is also stepped from the JAX state before it, carried into every
shard (``convert.sharded_block_state_from_numpy``): the map's keys,
slots and coords, the live counts, the visible lists and the step's
counters must then equal the JAX package's exactly, shard for shard;
poses agree within 5e-6 m and 5e-6 in the rotation, pools within the
fusion rule's response to such a pose (5e-4 on 99.9% of the TSDF and
equal weights on 99.9%), model maps within 1e-4 m on 99% of the pixels
both hit.  The free run is held within 1 mm and 1e-2 of the JAX run, the
tolerances of tests/test_block_sharded.py.  The shards' model maps come
out of one collective and must be bit-identical to each other.
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_block_sharded import make_cfg
from torch_sharded_world import pipeline_world
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.ops.blockmap import EMPTY_KEY
from topfusion_tpu.parallel.block_sharded import ShardedBlockPipeline as JaxSharded
from topfusion_tpu.parallel.block_sharded import _shard_cfg as jax_shard_cfg
from topfusion_tpu.parallel.block_sharded import make_mesh as jax_make_mesh
from topfusion_tpu_torch.convert import (
    block_state_to_numpy,
    config_from_reference,
    sharded_block_state_from_numpy,
    sharded_block_state_to_numpy,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.parallel import spawn_world

NS = 4
N_FRAMES = 6
PALLAS_FRAME = 3
MAP_FIELDS = ("bucket_keys", "bucket_slots", "block_coords", "num_blocks", "vis_slots")
COUNTS = ("num_blocks", "blocks_allocated", "num_visible", "blocks_dropped",
          "visible_overflow", "integrate_skipped")
POSE_TOL = 5e-6
TSDF_TOL = 5e-4
MAP_TOL = 1e-4


def aux_numpy(aux) -> dict:
    return {k: np.asarray(v) for k, v in aux._asdict().items()}


def jax_numpy(state) -> dict:
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = make_cfg()
    cfg_pallas = dataclasses.replace(
        cfg, blockmap=dataclasses.replace(cfg.blockmap, use_pallas_integrate=True))
    scene = SyntheticScene()
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=3.0, max_shift=0.03, seed=3)
    frames = [np.array(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in gt]
    mesh = jax_make_mesh(NS)
    jp = JaxSharded(cfg, mesh)
    init = jp.init()
    js, states, auxes = init, [], []
    for f in frames:
        js, aux = jp.step(js, jnp.asarray(f))
        states.append(js)
        auxes.append(aux_numpy(aux))
    zero, zero_aux = jp.step(states[-1], jnp.zeros_like(jnp.asarray(frames[0])))
    again, again_aux = jp.step(zero, jnp.asarray(frames[0]))
    # The Pallas kernel in interpret mode on the CPU mesh, as
    # tests/test_block_sharded.py runs it.
    pallas, pallas_aux = JaxSharded(cfg_pallas, mesh).step(
        states[PALLAS_FRAME - 1], jnp.asarray(frames[PALLAS_FRAME]))
    render = np.asarray(jp.render(states[-1]))

    inputs = dict(
        cfg=config_from_reference(cfg), cfg_pallas=config_from_reference(cfg_pallas),
        frames=frames, jax_states=[jax_numpy(s) for s in states],
        jax_zero_state=jax_numpy(zero), pallas_frame=PALLAS_FRAME,
    )
    tmp = tmp_path_factory.mktemp("sharded")
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ranks = spawn_world(pipeline_world, NS, "gloo", "cpu",
                        args=(str(path),), threads=1, timeout_s=600)
    return dict(cfg=cfg, gt=gt, frames=frames, ranks=ranks, init=jax_numpy(init),
                states=inputs["jax_states"], auxes=auxes,
                zero=inputs["jax_zero_state"], zero_aux=aux_numpy(zero_aux),
                again=jax_numpy(again), again_aux=aux_numpy(again_aux),
                pallas=jax_numpy(pallas), pallas_aux=aux_numpy(pallas_aux),
                render=render)


def local(arrays, rank) -> dict:
    """Shard ``rank``'s slice of a JAX global state, as the port's numpy."""
    return block_state_to_numpy(sharded_block_state_from_numpy(arrays, rank, NS, device="cpu"))


def assert_step_matches(got_ranks, want, got_aux, want_aux, what):
    """The checks of one carried step: ``got_ranks`` the shards' local
    states (numpy), ``want`` the JAX global state."""
    for r, got in enumerate(got_ranks):
        exp = local(want, r)
        for name in MAP_FIELDS + ("frame", "resets"):
            np.testing.assert_array_equal(got[name], exp[name], err_msg=f"{what} rank {r} {name}")
        np.testing.assert_allclose(got["T_wc"], exp["T_wc"], rtol=0, atol=POSE_TOL,
                                   err_msg=f"{what} rank {r} T_wc")
        t_off = np.abs(got["tsdf"] - exp["tsdf"]) > TSDF_TOL
        assert t_off.mean() <= 1e-3, (what, r, t_off.mean())
        assert (got["weight"] != exp["weight"]).mean() <= 1e-3, (what, r)
    for name in COUNTS:
        assert int(got_aux[name]) == int(want_aux[name]), (what, name)
    assert bool(got_aux["ok"]) == bool(want_aux["ok"]) and bool(got_aux["was_reset"]) == bool(
        want_aux["was_reset"]), what
    # Replicated model maps: bit-identical on every shard, close to JAX's.
    for level in range(len(want["model_points"])):
        for key in ("model_points", "model_normals"):
            for r in range(1, NS):
                np.testing.assert_array_equal(got_ranks[r][key][level], got_ranks[0][key][level],
                                              err_msg=f"{what} {key}[{level}] rank {r}")
        gp, wp = got_ranks[0]["model_points"][level], want["model_points"][level]
        both = np.any(gp != 0, axis=-1) & np.any(wp != 0, axis=-1)
        either = np.any(gp != 0, axis=-1) | np.any(wp != 0, axis=-1)
        assert both.sum() >= 0.99 * either.sum(), (what, level, both.sum(), either.sum())
        err = np.abs(gp[both] - wp[both]).max(axis=-1)
        assert (err <= MAP_TOL).sum() >= 0.99 * both.sum(), (what, level, err.max())


def test_world_banner_and_local_config(world):
    cfg = make_cfg()
    want = jax_shard_cfg(cfg, NS).blockmap
    for r, out in enumerate(world["ranks"]):
        assert out["banner"].startswith(f"map axis: {NS} shard(s) over gloo"), out["banner"]
        assert f"{r} -> cpu" in out["banner"]
        got = out["local_cfg"].blockmap
        for name in ("capacity", "max_visible_blocks", "max_new_blocks_per_frame"):
            assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("rank", range(NS))
def test_init_is_the_jax_slice(world, rank):
    got, want = world["ranks"][rank]["init"], local(world["init"], rank)
    assert got.keys() == want.keys()
    for name in got:
        for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (got[name], want[name]))):
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype and a.shape == b.shape, name


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_carried_frame_matches_jax(world, frame):
    got = [r["carried"][frame] for r in world["ranks"]]
    assert_step_matches([g["state"] for g in got], world["states"][frame], got[0]["aux"],
                        world["auxes"][frame], f"frame {frame}")
    for g in got[1:]:
        for name in COUNTS + ("ok", "residual", "num_inliers"):
            np.testing.assert_array_equal(g["aux"][name], got[0]["aux"][name], err_msg=name)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_global_layout_round_trip(world, frame):
    """The shards' local states put back into the global layout have the
    JAX package's shapes and dtypes, and the same map."""
    got = sharded_block_state_to_numpy([r["carried"][frame]["state"] for r in world["ranks"]])
    want = world["states"][frame]
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (g, w))):
            assert a.shape == b.shape and a.dtype == b.dtype, name
    for name in MAP_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_free_run_follows_jax(world):
    """The free-running sharded trajectory within tests/test_block_sharded.py's
    1 mm and 1e-2 of the JAX sharded run; every frame tracked on every shard."""
    want = np.stack([s["T_wc"] for s in world["states"]])
    for out in world["ranks"]:
        got = np.stack(out["free"]["poses"])
        assert all(bool(a["ok"]) for a in out["free"]["aux"])
        assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() < 1e-3
        assert np.abs(got[:, :3, :3] - want[:, :3, :3]).max() < 1e-2
        assert ate_rmse(list(got), list(world["gt"]), align=False) < 0.012
    for out in world["ranks"][1:]:
        np.testing.assert_array_equal(np.stack(out["free"]["poses"]),
                                      np.stack(world["ranks"][0]["free"]["poses"]))


def test_free_run_block_sets(world):
    """Ownership routes every block to one shard: no key twice over the
    shards, and the total within 5% of the JAX run's, which equals the
    shards' live counts summed."""
    states = [out["free"]["state"] for out in world["ranks"]]
    keys = np.concatenate([s["bucket_keys"].reshape(-1) for s in states])
    live = keys[keys != EMPTY_KEY]
    assert len(np.unique(live)) == len(live)
    total = sum(int(s["num_blocks"]) for s in states)
    assert len(live) == total
    assert int(world["ranks"][0]["free"]["aux"][-1]["num_blocks"]) == total
    n_jax = int(world["states"][-1]["num_blocks"].sum())
    assert abs(total - n_jax) <= max(16, 0.05 * n_jax), (total, n_jax)


def test_reset_on_zero_frame(world):
    """An all-zero frame fails tracking and resets every shard's map (the
    JAX package's tests/test_block_sharded.py:139); the next frame starts
    again as frame 0 did."""
    zs = [out["reset"]["zero"] for out in world["ranks"]]
    za = world["ranks"][0]["reset"]["zero_aux"]
    assert not bool(za["ok"]) and bool(za["was_reset"]) and int(za["num_blocks"]) == 0
    for z in zs:
        assert int(z["frame"]) == 0 and int(z["num_blocks"]) == 0
        assert (z["weight"] == 0).all()
    assert_step_matches(zs, world["zero"], za, world["zero_aux"], "zero frame")
    again = [out["reset"]["again"] for out in world["ranks"]]
    aa = world["ranks"][0]["reset"]["again_aux"]
    assert bool(aa["ok"]) and int(again[0]["frame"]) == 1 and int(aa["num_blocks"]) > 0
    assert_step_matches(again, world["again"], aa, world["again_aux"], "after the reset")


def test_pallas_flag_matches_jax_interpret(world):
    """``use_pallas_integrate`` on: the JAX step runs the Pallas kernel in
    interpret mode, the port the kernel's wrapper (its plain version on
    CPU tensors); one frame from the same carried state agrees as the
    other frames do."""
    got = [out["pallas"]["state"] for out in world["ranks"]]
    aux = world["ranks"][0]["pallas"]["aux"]
    assert_step_matches(got, world["pallas"], aux, world["pallas_aux"], "pallas frame")
    plain = [out["carried"][PALLAS_FRAME]["state"] for out in world["ranks"]]
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a["tsdf"], b["tsdf"])
        np.testing.assert_array_equal(a["weight"], b["weight"])


def test_render_matches_jax(world):
    """The composited render of the JAX state after the last frame: the
    same image on every shard, non-trivial, and within one grey level of
    the JAX render on 99% of the pixels."""
    imgs = [out["render"] for out in world["ranks"]]
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])
    img, want = imgs[0].astype(np.int32), world["render"].astype(np.int32)
    assert img.shape == want.shape and img.std() > 1.0
    assert (np.abs(img - want) <= 1).all(axis=-1).mean() >= 0.99


def test_world_of_one_is_block_pipeline(world):
    """One shard: ownership is the identity and every collective returns
    its input, so the sharded step is ``BlockPipeline.step`` bit for bit
    (state, model maps and aux, every frame); its render is the
    single-device march with the nearest-voxel weight gate, shaded."""
    out = world["ranks"][0]
    assert out["world1_same"] == [True] * N_FRAMES
    assert out["world1_num_blocks"] > 0
    assert out["world1_render_same"]


def test_dryrun_hook(world):
    assert all(out["dryrun"] for out in world["ranks"])


@pytest.mark.parametrize("frame", [0, N_FRAMES - 1])
def test_collective_traffic(world, frame):
    """The collectives of one step, counted from the shapes: one sum of
    the Gram matrix and count (50 floats) per ICP iteration, the two
    candidate gathers (a strip's coords and valid flags), the key image's
    pmin, the attribute image's psum and the counters' sum."""
    cfg = make_cfg()
    cam, bm = cfg.camera, cfg.blockmap
    n_iter = sum(cfg.icp.iters)
    strip = (cam.height // bm.alloc_pixel_stride // NS) * (cam.width // bm.alloc_pixel_stride)
    cand = strip * bm.alloc_steps
    pixels = cam.height * cam.width
    want_bytes = n_iter * 50 * 4 + cand * (3 * 4 + 1) + pixels * 4 + pixels * 5 * 4 + 5 * 4
    for out in world["ranks"]:
        got = out["carried"][frame]
        assert got["calls"] == n_iter + 2 + 2 + 1
        assert got["bytes"] == want_bytes
