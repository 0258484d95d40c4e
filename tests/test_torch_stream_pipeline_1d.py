"""The port's streaming pipeline on the ``2 x 1`` mesh (``make_pipe_mesh``'s
and ``run_stream``'s default): one gloo world of 2 CPU processes, stage
0 tracking and stage 1 fusing, against one JAX ``StreamBlockPipeline``
on ``make_pipe_mesh(2)``, at tests/test_stream_pipeline.py's 80x64
config over its 10-frame orbit; and against the same two stage functions
stepped in lockstep in one process (``run_lockstep``), which the world
must equal to the bit: the exchange only moves float32 values.

Carried steps and the free run are held as in
tests/test_torch_stream_pipeline.py; the free run also to the JAX
test's acceptance against the sequential pipeline
(tests/test_stream_pipeline.py:45-63).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_stream_pipeline import (
    N_GOOD,
    assert_free_run,
    assert_step_matches,
    assert_world_traffic,
    dense_pools,
    local_expected,
    stream_fixture,
)
from topfusion_tpu.config import tiny_test_config
from topfusion_tpu_torch.convert import (
    config_from_reference,
    stream_state_from_numpy,
    stream_state_to_numpy,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.parallel import (
    StreamBlockPipeline,
    dryrun_stream_step,
    make_pipe_mesh,
    run_stream,
)

N_MAP = 1
N_FRAMES = 10  # tests/test_stream_pipeline.py's orbit against the sequential pipeline


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return stream_fixture(N_MAP, N_FRAMES, tmp_path_factory)


@pytest.mark.parametrize("rank", range(2))
def test_init_is_the_jax_slice(world, rank):
    got, want = world["ranks"][rank]["init"], local_expected(world["orbit"]["vals"][0], rank, N_MAP)
    for part in ("state", "reg"):
        assert got[part].keys() == want[part].keys()
        for name in got[part]:
            g, w = got[part][name], want[part][name]
            for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (g, w))):
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{name}")
                assert a.dtype == b.dtype and a.shape == b.shape, name


@pytest.mark.parametrize("step", range(N_FRAMES))
def test_carried_step_matches_jax(world, step):
    got = [out["carried"][step] for out in world["ranks"]]
    assert_step_matches(got, world["orbit"]["vals"][step + 1], N_MAP, f"step {step}")


@pytest.mark.parametrize("step", range(2 * N_GOOD + 1))
def test_reset_sequence_carried(world, step):
    got = [out["reset_carried"][step] for out in world["ranks"]]
    assert_step_matches(got, world["reset"]["vals"][step + 1], N_MAP, f"reset step {step}")


def test_link_traffic(world):
    """Two broadcasts a step on the link, of the forward and the backward
    buffer; no collective on a row of one process."""
    assert_world_traffic(world)


def test_free_run_follows_jax(world):
    assert_free_run(world)


def test_world_is_the_lockstep_bit_for_bit(world):
    """Stage 0's trajectory, state and register and stage 1's map, model
    maps and register after the world's free run equal ``run_lockstep``'s
    in one process, to the bit."""
    s0, s1 = world["ranks"]
    lock = s0["lockstep"]
    np.testing.assert_array_equal(s0["free"]["poses"], lock["poses"])
    assert s0["free"]["digest"] == lock["stage0"]
    assert s0["free"]["reg_digest"] == lock["reg0"]
    assert s1["free"]["digest"] == lock["stage1"]
    assert s1["free"]["reg_digest"] == lock["reg1"]


def test_stream_against_the_sequential_pipeline(world):
    """tests/test_stream_pipeline.py:45-63 on the port: the stream's ATE
    (the model two frames behind) within 1.25 x the sequential
    ``BlockPipeline``'s + 2 mm, and under 3 voxels."""
    cfg = config_from_reference(world["cfg"])
    pipe = BlockPipeline(cfg, device="cpu")
    state, seq = pipe.init(), []
    for f in world["frames"]:
        state, aux = pipe.step(state, torch.from_numpy(f))
        assert bool(aux.ok)
        seq.append(state.T_wc.numpy().copy())
    gt = list(world["gt"])
    stream = world["ranks"][0]["free"]["poses"]
    ate_seq = ate_rmse(seq, gt, align=False)
    ate_stream = ate_rmse(list(stream), gt, align=False)
    assert ate_stream <= 1.25 * ate_seq + 2e-3, (ate_stream, ate_seq)
    assert ate_stream < 3 * cfg.tsdf.voxel_size


def test_run_stream_default_mesh(world):
    """``run_stream`` on its default ``2 x 1`` mesh returns stage 0's poses
    on both processes: the free run's."""
    for out in world["ranks"]:
        np.testing.assert_array_equal(out["run_stream"], world["ranks"][0]["free"]["poses"])


def test_mesh_refuses_a_world_of_another_size(world):
    """A world of 2 is no 2 x 2 mesh, a pipeline has 2 stages and a row at
    least one process: ``ValueError`` before any group is made."""
    for msg in world["ranks"][0]["refused"]:
        assert msg is not None
    assert "needs a world of 4, have 2" in world["ranks"][0]["refused"][0]


def test_entry_points_default_to_the_card():
    """Without CUDA and with no device named, every entry point raises
    before it starts anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs on it")
    cfg = config_from_reference(tiny_test_config())
    frames = np.zeros((1, cfg.camera.height, cfg.camera.width), np.uint16)
    calls = [lambda: make_pipe_mesh(), lambda: StreamBlockPipeline(cfg),
             lambda: run_stream(cfg, frames), lambda: dryrun_stream_step(2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_convert_defaults_to_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs on it")
    st, rg = world["orbit"]["vals"][0]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        stream_state_from_numpy(dense_pools(st), rg, 0, 0, 1)


def test_global_layout_round_trip(world):
    st_np, rg_np = world["orbit"]["vals"][-1]
    st_np = dense_pools(st_np)
    parts = [stream_state_from_numpy(st_np, rg_np, r, 0, 1, "cpu") for r in range(2)]
    state, reg = stream_state_to_numpy(parts)
    for got, want in ((state, st_np), (reg, rg_np)):
        for name in want:
            for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (got[name], want[name]))):
                assert a.shape == b.shape and a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_broadcast_over_the_pair(world):
    for out in world["ranks"]:
        assert out["broadcast"]["from1"] == [1.0] * 3
        assert out["broadcast"]["from0"] == [0.0] * 3


def test_dryrun_hook(world):
    assert all(out["dryrun"] for out in world["ranks"])
