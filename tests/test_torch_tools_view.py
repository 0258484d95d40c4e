"""The port's free-view viewer (``python -m topfusion_tpu_torch.tools.view``)
on a run directory made from a JAX-mapped 80x64 state (the map of
tests/test_freeview.py), with the configuration as config.yaml and as
config.json (the app writes the latter where pyyaml is missing): each
key script's final pose (moves, and the orbit key "o") against the JAX
package's ``move_pose`` / ``orbit_path`` over the same keys, and
``view.png`` against the JAX
``BlockPipeline.render`` at that pose, by tests/test_torch_rendering.py's
rule (at most 1% of the pixels more than one grey level apart)."""

import contextlib
import io
import json
import os

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_freeview import _mapped_state
from topfusion_tpu.geometry.viewpath import map_centroid, move_pose, orbit_path
from topfusion_tpu.utils.checkpoint import save_state
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.tools import view
from topfusion_tpu_torch.utils.config_io import save_config

# "q" ends a replay: the "o" after it in the first script is never applied.
SCRIPTS = ("wjsqo", "wojq")
STEP, DEG = 0.02, 10.0
GREY_TOL = 1

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mapped():
    """The JAX map, and for each key script the pose and render it should
    end at."""
    cfg, pipe, state = _mapped_state()
    bm = cfg.blockmap.block_size * cfg.tsdf.voxel_size
    center = map_centroid(np.asarray(state.block_coords), int(state.num_blocks), bm)
    ends = {}
    for script in SCRIPTS:
        T = np.asarray(state.T_wc)
        for k in script:
            if k == "q":
                break
            T = (orbit_path(center, T, 8)[1] if k == "o"
                 else move_pose(T, k, step_m=STEP, step_deg=DEG))
        ends[script] = dict(T=T, render=np.asarray(pipe.render(state, jnp.asarray(T))))
    return dict(cfg=cfg, state=state, ends=ends)


@pytest.fixture(scope="module", params=[(c, s) for c in ("config.yaml", "config.json")
                                        for s in SCRIPTS], ids="-".join)
def replay(request, mapped, tmp_path_factory):
    config, script = request.param
    run_dir = str(tmp_path_factory.mktemp("run"))
    save_config(os.path.join(run_dir, config), config_from_reference(mapped["cfg"]))
    save_state(os.path.join(run_dir, "state.npz"), mapped["state"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert view.main([run_dir, "--script", script, "--step", str(STEP), "--deg", str(DEG),
                          "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    final = [ln for ln in lines if ln.startswith("final pose ")]
    return dict(run_dir=run_dir, lines=lines, script=script, want=mapped["ends"][script],
                T=np.asarray(json.loads(final[0][len("final pose "):]), np.float32))


def test_final_pose_matches_jax(replay):
    np.testing.assert_array_equal(replay["T"], replay["want"]["T"])
    # The map line, the first render and one per move before the quit.
    assert replay["lines"][0].startswith("map: ")
    assert sum("coverage" in ln for ln in replay["lines"]) == 1 + replay["script"].index("q")


def test_view_png_matches_jax_render(replay):
    got = iio.imread(os.path.join(replay["run_dir"], "view.png"))
    want = replay["want"]["render"]
    assert got.shape == want.shape == (64, 80, 3) and got.dtype == np.uint8
    differ = (np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1) > GREY_TOL).mean()
    assert differ <= 0.01, differ
    assert got.std() > 10
