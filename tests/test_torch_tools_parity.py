"""The port's exact-vs-fast parity A/B (``python -m
topfusion_tpu_torch.tools.parity_ab``) and the exact mode
(``config.reference_exact_config``) through the port's ``BlockPipeline``.

* The exact configuration's step against the JAX package's, the JAX
  state carried in before each frame, by
  tests/test_torch_pipeline_block.py's rule: poses within 0.25 mm and
  0.01 degrees, block counts exactly equal.
* The tool's ``run_mode`` at tests/test_parity.py's configuration and
  frame count meets that file's assertions: fast <= 1.1 x exact + 0.2
  voxels, both below half a voxel.  (The tool's own ``--small`` camera
  keeps the default 5 mm voxels, where neither package meets that rule:
  at 16 frames the JAX script measures exact 1.78 / fast 6.29 mm at
  noise 0, the port 1.78 / 6.30 mm, on the CPU.)
* The tool's command line, ``--small`` on the CPU, prints its rows and
  its table."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity import N_FRAMES, make_fast_cfg
from tests.test_torch_pipeline_block import jax_state_numpy, rot_deg
from topfusion_tpu.config import reference_exact_config as j_exact
from topfusion_tpu.io.synthetic import SyntheticScene, add_depth_noise, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu_torch.config import reference_exact_config
from topfusion_tpu_torch.convert import block_state_from_numpy, config_from_reference
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.tools import parity_ab

CARRIED = (1, 2)  # frames stepped from the carried JAX state
COUNTS = ("num_blocks", "blocks_allocated", "num_visible", "blocks_dropped", "visible_overflow")

torch.set_num_threads(2)


def depths(noise_mm):
    """tests/test_parity.py's frames: the 16-frame orbit at 160x120."""
    cam = make_fast_cfg().camera
    scene = SyntheticScene()
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=5.0, max_shift=0.05, seed=2)
    return gt, [add_depth_noise(np.asarray(scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32))),
                                noise_mm, seed=1000 + i) for i, T in enumerate(gt)]


@pytest.fixture(scope="module")
def exact_run():
    """The JAX exact mode over the first frames at noise 1 mm: the state
    before each frame, and the pose and counts after it."""
    cfg = j_exact(make_fast_cfg())
    _, frames = depths(1.0)
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    before, after = [], []
    for f in frames[:max(CARRIED) + 1]:
        before.append(jax_state_numpy(state))
        state, aux = pipe.step(state, jnp.asarray(f))
        after.append((np.asarray(state.T_wc), {k: int(getattr(aux, k)) for k in COUNTS},
                      bool(aux.ok)))
    return cfg, frames, before, after


def test_exact_config_flips_every_deviation():
    tc = reference_exact_config(config_from_reference(make_fast_cfg()))
    assert tc == config_from_reference(j_exact(make_fast_cfg()))
    assert tc.icp.gather_mode == "take" and tc.icp.bilinear and tc.icp.level0_stride == 1
    assert tc.raycast.model_maps == "raycast" and not tc.raycast.guided
    assert tc.preproc.reference_edge_semantics
    assert tc.blockmap.use_pallas_integrate is False and not tc.blockmap.visible_occlusion_cull


@pytest.mark.parametrize("frame", CARRIED)
def test_exact_step_follows_jax(exact_run, frame):
    cfg, frames, before, after = exact_run
    pipe = BlockPipeline(config_from_reference(cfg), device="cpu")
    state, aux = pipe.step(block_state_from_numpy(before[frame], device="cpu"),
                           torch.from_numpy(frames[frame]))
    T_j, counts_j, ok_j = after[frame]
    T_t = state.T_wc.numpy()
    assert bool(aux.ok) and ok_j
    assert np.abs(T_t[:3, 3] - T_j[:3, 3]).max() <= 2.5e-4
    assert rot_deg(T_t[:3, :3], T_j[:3, :3]) <= 0.01
    assert {k: int(getattr(aux, k)) for k in COUNTS} == counts_j


@pytest.mark.parametrize("noise_mm", [0.0, 1.0])
def test_run_mode_meets_parity_rule(noise_mm):
    """tests/test_parity.py's assertions on the port, through the tool's
    ``run_mode`` (every frame must track)."""
    fast = config_from_reference(make_fast_cfg())
    exact = reference_exact_config(fast)
    gt, frames = depths(noise_mm)
    frames = [torch.from_numpy(f.copy()) for f in frames]
    ate_exact, _, _ = parity_ab.run_mode(exact, frames, gt, "cpu")
    ate_fast, _, _ = parity_ab.run_mode(fast, frames, gt, "cpu")
    voxel = fast.tsdf.voxel_size
    assert ate_fast <= 1.1 * ate_exact + 0.2 * voxel, (ate_fast, ate_exact)
    assert ate_exact < 0.5 * voxel and ate_fast < 0.5 * voxel


def test_command_line_rows():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert parity_ab.main(["--small", "--frames", "3", "--noise", "1", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("noise 1.0 mm: exact ATE ") and "fast/exact = " in lines[0]
    assert "| noise (mm) | exact ATE (mm) | fast ATE (mm) | fast/exact |" in lines[2]
    row = lines[4].strip("|").split("|")
    assert len(row) == 6 and float(row[0]) == 1.0
    assert all(np.isfinite(float(v)) for v in row)
