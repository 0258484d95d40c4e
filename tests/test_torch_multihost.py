"""The port's multi-process runtime (``parallel/multihost.py``):
``initialize_multihost`` from a launcher's environment, the sharded
block-pipeline demo against the JAX package's (tests/test_multihost.py),
its elastic restart from per-rank checkpoints after one rank dies, the
scaling harness, and the entry points' default device.

The demo's free run is held to the JAX demo on a mesh of 4 within
tests/test_block_sharded.py's tolerances for a free sharded run against
another (1 mm on the poses' translation, 1e-2 on their rotation), and
its block and visible counts within 1%: the two packages' renders of the
demo's frames differ by 1 mm in one pixel, the port sums ICP's partials
in another order than XLA's mesh, and the demo's tracker (64x48, 3 + 2
iterations) amplifies either into 0.58 mm after 4 frames (measured on
the CPU).  tests/test_multihost.py's 1e-4 compares two JAX runs that
differ only in their transport.  The restarted world must land exactly
where the uninterrupted world of the same size landed.
"""

import multiprocessing
import os
import pickle
import shutil
import socket
import time

import numpy as np
import pytest
import torch

from tests.test_block_sharded import make_cfg as block_cfg
from torch_sharded_world import demo_world, env_world_child
from topfusion_tpu.parallel.multihost import run_block_pipeline_demo as jax_demo
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.parallel import ShardedSlamSystem, make_sharded_pipeline, spawn_world
from topfusion_tpu_torch.parallel import multihost

DEMO_NS, DEMO_FRAMES = 4, 4
RESUME_NS, RESUME_FRAMES, CRASH_AT = 2, 8, 5


@pytest.fixture(scope="module")
def demo():
    want = jax_demo(n_devices=DEMO_NS, n_frames=DEMO_FRAMES)
    got = spawn_world(demo_world, DEMO_NS, "gloo", "cpu", args=(DEMO_FRAMES,), threads=1)
    return want, got


def test_demo_matches_jax(demo):
    want, got = demo
    for r in got:
        assert r["resumed_at"] == 0 and len(r["poses"]) == DEMO_FRAMES
        assert np.abs(r["poses"][:, :3, 3] - want["poses"][:, :3, 3]).max() < 1e-3
        assert np.abs(r["poses"][:, :3, :3] - want["poses"][:, :3, :3]).max() < 1e-2
        assert abs(r["num_blocks"] - want["num_blocks"]) <= 0.01 * want["num_blocks"]
        assert abs(r["num_visible"] - want["num_visible"]) <= 0.01 * want["num_visible"]
        np.testing.assert_array_equal(r["poses"], got[0]["poses"])


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    """An uninterrupted world of 2 over the demo's 8 frames with a
    checkpoint every 2 frames, and one whose rank 1 dies hard after frame
    5, past the frame-4 checkpoint (the world fails as a whole).  Returns
    the uninterrupted ranks' results, the crashed world's checkpoint path
    and error, and a checkpoint set of mixed epochs: rank 0's from the
    crash (frame 4), rank 1's from the uninterrupted run (frame 8)."""
    tmp = tmp_path_factory.mktemp("resume")
    ref_ckpt, ckpt, mixed = str(tmp / "ref"), str(tmp / "ckpt"), str(tmp / "mixed")
    ref = spawn_world(demo_world, RESUME_NS, "gloo", "cpu", threads=1,
                      args=(RESUME_FRAMES, ref_ckpt))
    with pytest.raises(RuntimeError) as err:
        spawn_world(demo_world, RESUME_NS, "gloo", "cpu", threads=1,
                    args=(RESUME_FRAMES, ckpt, CRASH_AT))
    shutil.copy(f"{ckpt}.proc0.npz", f"{mixed}.proc0.npz")
    shutil.copy(f"{ref_ckpt}.proc1.npz", f"{mixed}.proc1.npz")
    return dict(ref=ref, ckpt=ckpt, error=str(err.value), mixed=mixed)


def test_kill_one_rank_and_resume(crashed):
    """The crashed world restarts, every rank restores its own shard from
    the frame-4 checkpoint, and the run ends bit-identical to the
    uninterrupted world's."""
    assert "rank 1: exit code 17" in crashed["error"]
    ckpt = crashed["ckpt"]
    for r in range(RESUME_NS):
        assert os.path.exists(f"{ckpt}.proc{r}.npz")
    got = spawn_world(demo_world, RESUME_NS, "gloo", "cpu", threads=1, args=(RESUME_FRAMES, ckpt))
    for g, w in zip(got, crashed["ref"]):
        assert g["resumed_at"] == 4 and len(g["poses"]) == RESUME_FRAMES
        np.testing.assert_array_equal(g["poses"], w["poses"])
        assert g["num_blocks"] == w["num_blocks"]


def test_mixed_checkpoints_refuse_to_resume(crashed):
    """Ranks whose checkpoints are of different frames would wait in each
    other's collectives: the restart raises on every rank instead."""
    with pytest.raises(RuntimeError, match="restored frames"):
        spawn_world(demo_world, RESUME_NS, "gloo", "cpu", threads=1,
                    args=(RESUME_FRAMES, crashed["mixed"]))


def test_initialize_multihost_from_the_environment(tmp_path):
    """Two processes started as a launcher starts them, with
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``: gloo
    (no card), one world, a sum over both."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    paths = [str(tmp_path / f"out-{r}.pkl") for r in range(2)]
    procs = [ctx.Process(target=env_world_child, args=(r, 2, port, paths[r])) for r in range(2)]
    for p in procs:
        p.start()
    # A rank that fails leaves the other waiting for it: the wait ends at
    # the first failure, and kills what still runs.
    deadline = time.monotonic() + 120
    try:
        codes = [p.exitcode for p in procs]
        while None in codes and not any(codes):
            assert time.monotonic() < deadline, "the world outlived 120 s"
            time.sleep(0.05)
            codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r, path in enumerate(paths):
        with open(path, "rb") as f:
            out = pickle.load(f)
        assert out == dict(backend="gloo", rank=r, size=2, total=1.0)


def test_initialize_multihost_single_process_is_a_no_op(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_multihost() is None
    assert not torch.distributed.is_initialized()


def test_measure_scaling_block_returns_its_keys():
    """Worlds of 1 and 2 gloo processes on the CPU: frames/s for each, the
    backend and cards, and no efficiency (the processes share no card of
    their own), with the reason."""
    res = multihost.measure_scaling_block(multihost._demo_config(1), n_frames=2,
                                          device_counts=(1, 2), mode="weak", device="cpu")
    assert res[1] > 0 and res[2] > 0
    assert res["mode"] == "weak" and res["device"] == "cpu"
    assert res["backend"] == {1: "gloo", 2: "gloo"} and res["cards"] == {1: 0, 2: 0}
    assert res["efficiency"] is None and "not scaling" in res["efficiency_note"]


@pytest.mark.parametrize("entry", ["ShardedSlamSystem", "make_sharded_pipeline",
                                   "run_block_pipeline_demo", "measure_scaling",
                                   "measure_scaling_block"])
def test_entry_points_default_to_the_card(entry):
    """Without a device named, each entry point asks for the card and
    raises where there is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs on it")
    cfg = config_from_reference(block_cfg())
    calls = {
        "ShardedSlamSystem": lambda: ShardedSlamSystem(cfg),
        "make_sharded_pipeline": lambda: make_sharded_pipeline(cfg),
        "run_block_pipeline_demo": lambda: multihost.run_block_pipeline_demo(),
        "measure_scaling": lambda: multihost.measure_scaling(cfg),
        "measure_scaling_block": lambda: multihost.measure_scaling_block(cfg),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()
