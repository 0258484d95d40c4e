"""The ICL-NUIM camera convention (fy < 0, image v growing as camera-space
y decreases) in the port, held to tests/test_negative_fy.py on the CPU:
the vertex and normal maps against the JAX package's, every frame of the
JAX test's 6-frame orbit stepped from the JAX state carried into the
port, and the port's own free runs at fy < 0 and fy > 0 to the JAX test's
acceptance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_frontend import NORMAL_TOL, POINT_TOL
from tests.test_torch_pipeline_block import jax_state_numpy, rot_deg
from topfusion_tpu.config import tiny_test_config
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops.normals import compute_points_normals as j_points_normals
from topfusion_tpu_torch.convert import block_state_from_numpy, config_from_reference
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.ops.normals import compute_points_normals

torch.set_num_threads(2)

N_FRAMES = 6  # tests/test_negative_fy.py::_run


def neg_fy(cfg):
    return dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, fy=-cfg.camera.fy))


def orbit_frames(cfg):
    """tests/test_negative_fy.py::_run's orbit and its u16 frames under
    ``cfg``'s camera, as numpy."""
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=4.0, max_shift=0.04, seed=6)
    scene = SyntheticScene()
    return gt, [np.array(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
                for T in gt]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pipeline over the orbit at fy < 0: the frames, and the
    state before and the pose after every frame."""
    cfg = neg_fy(tiny_test_config())
    gt, frames = orbit_frames(cfg)
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    before, poses = [], []
    for f in frames:
        before.append(jax_state_numpy(state))
        state, aux = pipe.step(state, jnp.asarray(f))
        assert bool(aux.ok)
        poses.append(np.asarray(state.T_wc))
    return cfg, gt, frames, before, poses


def test_normals_match_jax_and_face_the_camera():
    cfg = neg_fy(tiny_test_config())
    mm = np.asarray(SyntheticScene().render_depth_mm(cfg.camera, jnp.eye(4)))
    depth = mm.astype(np.float32) / np.float32(1000.0)
    pj, nj = j_points_normals(cfg.camera, jnp.asarray(depth))
    pt, nt = compute_points_normals(config_from_reference(cfg).camera, torch.from_numpy(depth))
    pt, nt = pt.numpy(), nt.numpy()
    np.testing.assert_allclose(pt, np.asarray(pj), atol=POINT_TOL)
    np.testing.assert_allclose(nt, np.asarray(nj), atol=NORMAL_TOL)
    valid = np.any(nt != 0.0, axis=-1)
    assert valid.sum() > 100
    # Every valid normal faces the camera (dot with the viewing ray <= 0).
    assert (np.sum(nt[valid] * pt[valid], axis=-1) <= 1e-6).all()


@pytest.mark.parametrize("frame", range(1, N_FRAMES))
def test_port_steps_as_jax_under_negative_fy(jax_run, frame):
    """Each frame from the JAX state before it: the pose within
    tests/test_torch_pipeline_block.py's 0.25 mm and 0.01 degrees of the
    JAX step's."""
    cfg, _, frames, before, poses = jax_run
    pipe = BlockPipeline(config_from_reference(cfg), device="cpu")
    state, aux = pipe.step(block_state_from_numpy(before[frame], device="cpu"),
                           torch.from_numpy(frames[frame]))
    assert bool(aux.ok)
    Tt, Tj = state.T_wc.numpy(), poses[frame]
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01


def test_port_free_runs_meet_the_jax_acceptance():
    """tests/test_negative_fy.py::test_tracking_under_negative_fy on the
    port: every frame tracked without a reset at fy < 0 and fy > 0, and
    ATE_neg < 1.3 ATE_pos + 0.1 mm and below two voxels."""
    ates = []
    for cfg in (neg_fy(tiny_test_config()), tiny_test_config()):
        gt, frames = orbit_frames(cfg)
        pipe = BlockPipeline(config_from_reference(cfg), device="cpu")
        state, est = pipe.init(), []
        for f in frames:
            state, aux = pipe.step(state, torch.from_numpy(f))
            assert bool(aux.ok)
            est.append(state.T_wc.numpy().copy())
        assert int(state.resets) == 0
        ates.append(ate_rmse(est, gt, align=False))
    ate_neg, ate_pos = ates
    assert ate_neg < 1.3 * ate_pos + 1e-4, (ate_neg, ate_pos)
    assert ate_neg < 2.0 * tiny_test_config().tsdf.voxel_size
