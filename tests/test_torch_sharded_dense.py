"""The port's sharded dense pipeline (``parallel/sharded_pipeline.py``)
against the JAX package's: gloo worlds of 2 and 4 CPU processes against
JAX ``make_sharded_pipeline`` on meshes of 2 and 4 virtual CPU devices,
at the JAX dry run's size (``sharded_pipeline.py:88-110``: a 64x48
camera, a grid of 8 n x 64 x 64), over the first frames of a small orbit
from ``init``.

How the runs are compared.  Each shard holds a slab of dim 0 and gathers
the whole volume for the raycast, so the shards' poses and model maps
are bit-identical, and every shard's slab is the JAX volume's slice.
The two packages round the fusion step's pose and ICP's sums apart (XLA
contracts multiply-adds the port rounds apart), so poses agree within
1e-5 and the volumes within 1e-3 on all but 0.1% of the voxels, and the
weights exactly on all but 0.1%: the tolerances of
tests/test_torch_pipeline_dense.py.  A world of one shard is
``DensePipeline``, bit for bit; the collectives per frame are the two
gathers of the slabs the raycast reads.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from torch_sharded_world import dense_world
from topfusion_tpu.config import (
    CameraConfig,
    DenseVolumeConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.parallel.sharded_pipeline import make_mesh as jax_make_mesh
from topfusion_tpu.parallel.sharded_pipeline import make_sharded_pipeline as jax_make_sharded
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.parallel import spawn_world

WORLDS = (2, 4)
N_FRAMES = 4
POSE_TOL = 1e-5
TSDF_TOL = 1e-3


def dryrun_cfg(ns: int) -> PipelineConfig:
    """The JAX dry run's configuration for ``ns`` devices."""
    d = 8 * ns
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2)),
        dense=DenseVolumeConfig(dims=(d, 64, 64), origin=(-0.32, -0.32, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.64 / d, trunc_dist=0.04),
        raycast=RaycastConfig(max_steps=48),
    )


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    scene = SyntheticScene()
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=2.0, max_shift=0.02, seed=7)
    out = {}
    for ns in WORLDS:
        cfg = dryrun_cfg(ns)
        frames = [np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
                  for T in gt]
        init, step = jax_make_sharded(cfg, jax_make_mesh(ns))
        st, states, auxes = init(), [], []
        for f in frames:
            st, aux = step(st, jnp.asarray(f))
            states.append({k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                               else np.asarray(v)) for k, v in st._asdict().items()})
            auxes.append({k: np.asarray(v) for k, v in aux._asdict().items()})
        path = tmp_path_factory.mktemp(f"dense{ns}") / "inputs.pkl"
        with open(path, "wb") as f:
            pickle.dump(dict(cfg=config_from_reference(cfg), frames=frames), f)
        ranks = spawn_world(dense_world, ns, "gloo", "cpu", args=(str(path),), threads=1,
                            timeout_s=600)
        out[ns] = dict(cfg=cfg, states=states, auxes=auxes, ranks=ranks)
    return out


@pytest.mark.parametrize("ns", WORLDS)
@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_matches_jax_mesh(worlds, ns, frame):
    w = worlds[ns]
    want, want_aux = w["states"][frame], w["auxes"][frame]
    d0 = w["cfg"].dense.dims[0] // ns
    for r, rank in enumerate(w["ranks"]):
        got = rank["steps"][frame]
        st, aux = got["state"], got["aux"]
        assert bool(aux["ok"]) == bool(want_aux["ok"]) and not bool(aux["was_reset"])
        assert int(st["frame"]) == int(want["frame"]) and int(st["resets"]) == int(want["resets"])
        np.testing.assert_allclose(st["T_wc"], want["T_wc"], rtol=0, atol=POSE_TOL)
        assert st["tsdf"].shape == (d0,) + want["tsdf"].shape[1:]
        sl = slice(r * d0, (r + 1) * d0)
        assert (np.abs(st["tsdf"] - want["tsdf"][sl]) > TSDF_TOL).mean() <= 1e-3
        assert (st["weight"] != want["weight"][sl]).mean() <= 1e-3
        np.testing.assert_array_equal(st["color"], want["color"])  # the dummy
        for key in ("model_points", "model_normals"):
            for level, m in enumerate(st[key]):
                np.testing.assert_array_equal(m, w["ranks"][0]["steps"][frame]["state"][key][level])


@pytest.mark.parametrize("ns", WORLDS)
def test_model_maps_match_jax(worlds, ns):
    """The last frame's model points within 1e-4 m of JAX's on 99% of the
    pixels both hit, and the same hits on 99%."""
    w = worlds[ns]
    gp = w["ranks"][0]["steps"][-1]["state"]["model_points"][0]
    wp = w["states"][-1]["model_points"][0]
    both = np.any(gp != 0, axis=-1) & np.any(wp != 0, axis=-1)
    either = np.any(gp != 0, axis=-1) | np.any(wp != 0, axis=-1)
    assert both.sum() > 0 and both.sum() >= 0.99 * either.sum()
    err = np.abs(gp[both] - wp[both]).max(axis=-1)
    assert (err <= 1e-4).mean() >= 0.99, err.max()


@pytest.mark.parametrize("ns", WORLDS)
def test_gathered_bytes_per_frame(worlds, ns):
    """Two gathers per frame, each of this shard's float32 slab."""
    dims = worlds[ns]["cfg"].dense.dims
    for rank in worlds[ns]["ranks"]:
        for got in rank["steps"]:
            assert got["calls"] == 2
            assert got["bytes"] == 2 * 4 * dims[0] * dims[1] * dims[2] // ns


@pytest.mark.parametrize("ns", WORLDS)
def test_world_of_one_is_dense_pipeline(worlds, ns):
    assert worlds[ns]["ranks"][0]["world1_same"] == [True] * N_FRAMES


@pytest.mark.parametrize("ns", WORLDS)
def test_dryrun_hook(worlds, ns):
    assert all(r["dryrun"] for r in worlds[ns]["ranks"])
