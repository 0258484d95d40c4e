"""The port's SLAM system with ``blockmap.out_of_core`` (the host cache's
restore before and evict after every chunk, ``remap_store`` after a
rebuild) against the JAX package's on the CPU, on tests/test_swap.py's
corridor: 15 frames out (pitched camera, 6 cm steps) and back, a pool of
2048 blocks, keyframes every 3 frames, every loop correction rebuilding
the map.

The corridor at 80x64 is badly conditioned for ICP: 1e-6 m in a model
map moves the next pose by up to 0.6 mm (tests/test_torch_swap.py), so
the JAX run is the master and the port runs each FRAME (``process_frame``,
a chunk of one) from the JAX system's state and host cache before it.
Per frame: the same decisions (ok, reset, blocks dropped, loop, rebuild,
keyframes, edges), and the pose and the map but for what ICP makes of
ulps here.  The JAX package jits the whole chunk, whose fusions round
otherwise than its jitted step does (tests/test_torch_swap.py holds the
step alone to 0.25 mm), and on this scene one ICP turns that into up to
1 mm (measured: 0.98 mm at frame 18, under 0.25 mm elsewhere); a
candidate point near a block face then allocates another block
(measured: 8 of 1024 live blocks at frame 1).  So the pose agrees within
1.5 mm and the live blocks and host-store keys as sets within 1%.  A free-running port sweep is
held to tests/test_swap.py's out-of-core smoke test."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_swap import port_cache_like
from topfusion_tpu.config import tiny_test_config
from topfusion_tpu.geometry.se3 import se3_exp
from topfusion_tpu.io.synthetic import corridor_scene, sweep_trajectory
from topfusion_tpu.models.slam import SlamSystem as JaxSlam
from topfusion_tpu_torch.convert import (
    config_from_reference,
    slam_state_from_numpy,
    slam_state_to_numpy,
)
from topfusion_tpu_torch.models.slam import SlamSystem

torch.set_num_threads(2)


def corridor_cfg(**posegraph):
    base = tiny_test_config()
    return dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
        blockmap=dataclasses.replace(base.blockmap, capacity=1 << 11,
                                     max_visible_blocks=1 << 11, out_of_core=True),
        posegraph=dataclasses.replace(base.posegraph, **posegraph),
    )


@functools.lru_cache(maxsize=None)
def corridor_frames(n_fwd: int, back: bool):
    pitch = np.asarray(se3_exp(jnp.asarray([0.35, 0, 0, 0, 0, 0], jnp.float32)))
    scene = corridor_scene(length_m=6.5, box_every=0.35)
    fwd = [T @ pitch for T in sweep_trajectory(n_fwd, step_m=0.06)]
    gt = fwd + fwd[::-1][1:] if back else fwd
    cam = tiny_test_config().camera
    return np.stack([np.asarray(scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32)))
                     for T in gt])


REBUILD = dict(min_map_correction=0.0, keyframe_every=3, loop_max_dist=0.5)


@pytest.fixture(scope="module")
def swept():
    """tests/test_swap.py::test_swap_store_survives_reintegration's run,
    frame by frame, the port from the JAX state and cache before each."""
    cfg = corridor_cfg(**REBUILD)
    js = JaxSlam(cfg)
    ts = SlamSystem(config_from_reference(cfg), device="cpu")
    rows = []
    for f in corridor_frames(15, True):
        slam_state_from_numpy(slam_state_to_numpy(js), ts)
        ts.swap = port_cache_like(js.swap, ts.cfg)
        t_info = ts.process_frame(f)
        j_info = js.process_frame(f)
        rows.append(dict(t=t_info, j=j_info, got=slam_state_to_numpy(ts),
                         want=slam_state_to_numpy(js),
                         t_keys=list(ts.swap.store), j_keys=list(js.swap.store)))
    return rows


@pytest.mark.parametrize("frame", range(29))
def test_out_of_core_frame_follows_jax(swept, frame):
    r = swept[frame]
    for key in ("ok", "reset", "dropped", "loop", "reintegrated"):
        assert r["t"].get(key) == r["j"].get(key), key
    assert abs(r["t"]["blocks"] - r["j"]["blocks"]) <= 0.01 * r["j"]["blocks"]
    assert len(set(r["t_keys"]) ^ set(r["j_keys"])) <= 0.01 * len(r["j_keys"]) + 2
    got, want = r["got"], r["want"]
    for key in ("loops_closed", "reintegrations", "kf_for_frame"):
        assert got[key] == want[key], key

    def live(st):
        return {tuple(c) for c in st["block_coords"][: int(st["num_blocks"])]}

    assert len(live(got["state"]) ^ live(want["state"])) <= 0.01 * int(want["state"]["num_blocks"])
    assert np.abs(got["odom_poses"][-1][:3, 3] - want["odom_poses"][-1][:3, 3]).max() <= 1.5e-3
    for name in ("num_kf", "num_edges", "edge_i", "edge_j", "edge_is_loop"):
        np.testing.assert_array_equal(got["graph"][name], want["graph"][name], err_msg=name)


def test_out_of_core_run_spills_and_rebuilds(swept):
    """The comparison covered evictions and a rebuild with a store to
    carry through it (host_cache.remap_store)."""
    last = swept[-1]
    assert len(last["j_keys"]) > 0 and last["want"]["reintegrations"] >= 1
    assert any(r["t"].get("reintegrated") and r["t_keys"] for r in swept)


def test_port_out_of_core_smoke():
    """tests/test_swap.py::test_slam_system_out_of_core_smoke on the port,
    free-running: a chunked 24-frame corridor sweep spills under pressure
    and keeps tracking."""
    cfg = config_from_reference(corridor_cfg())
    slam = SlamSystem(cfg, device="cpu")
    assert slam.swap is not None
    frames = corridor_frames(24, False)
    ke = cfg.posegraph.keyframe_every
    infos = []
    for s in range(0, len(frames) - len(frames) % ke, ke):
        infos += slam.process_chunk(frames[s:s + ke])
    assert all(i["ok"] for i in infos[1:])
    assert slam.swap.n_host_blocks > 0, "never spilled despite pressure"
