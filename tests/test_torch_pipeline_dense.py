"""The dense slice end to end: the port's ``DensePipeline`` against the
JAX package's on the 10-frame 80x64 / 96^3 sequence of
tests/test_pipeline_dense.py (guided raycast model maps, its default), the
full-march branch, color, the renders, a JAX state carried into the port
and back, and reset on a garbage frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_dense import make_cfg
from tests.test_torch_pipeline_block import jax_state_numpy, rot_deg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.pipeline import DensePipeline as JaxPipeline
from topfusion_tpu.models.pipeline import DenseState as JaxState
import topfusion_tpu_torch
from topfusion_tpu_torch.convert import (
    config_from_reference,
    dense_state_from_numpy,
    dense_state_to_numpy,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.models.pipeline import DensePipeline, DenseState

torch.set_num_threads(2)

N_FRAMES = 10
CARRY_AT = 5


def color_cfg(guided=True):
    cfg = make_cfg()
    return dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, use_color=True),
        raycast=dataclasses.replace(cfg.raycast, guided=guided),
    )


@pytest.fixture(scope="module")
def runs():
    """Both pipelines over the sequence through ``step_rgb`` (a color grid;
    the poses do not depend on it), and the JAX state after CARRY_AT frames."""
    cfg = color_cfg()
    scene = SyntheticScene()
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [np.array(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in gt]
    rgbs = [np.array(scene.render_rgb(cfg.camera, jnp.asarray(T, jnp.float32))) for T in gt]
    jp = JaxPipeline(cfg)
    js = jp.init()
    tp = DensePipeline(config_from_reference(cfg), device="cpu")
    ts = tp.init()
    j_poses, j_aux, t_poses, t_aux, carried = [], [], [], [], None
    for i, (f, c) in enumerate(zip(frames, rgbs)):
        if i == CARRY_AT:
            carried = jax_state_numpy(js)
        js, ja = jp.step_rgb(js, jnp.asarray(f), jnp.asarray(c))
        ts, ta = tp.step_rgb(ts, torch.from_numpy(f), torch.from_numpy(c))
        j_poses.append(np.asarray(js.T_wc))
        t_poses.append(ts.T_wc.numpy().copy())
        j_aux.append(jax.tree.map(np.asarray, ja))
        t_aux.append(ta)
    return dict(cfg=cfg, gt=gt, frames=frames, rgbs=rgbs, jp=jp, js=js, tp=tp, ts=ts,
                j_poses=j_poses, j_aux=j_aux, t_poses=t_poses, t_aux=t_aux, carried=carried)


def test_port_tracks_every_frame(runs):
    assert all(bool(a.ok) for a in runs["t_aux"])
    assert not any(bool(a.was_reset) for a in runs["t_aux"])
    assert int(runs["ts"].resets) == 0 and int(runs["ts"].frame) == N_FRAMES
    assert int(runs["js"].resets) == 0 and int(runs["js"].frame) == N_FRAMES
    assert runs["ts"].frame.dtype == torch.int32 and runs["ts"].resets.dtype == torch.int32


def test_port_ate_bound(runs):
    """The JAX test's bound (tests/test_pipeline_dense.py)."""
    assert ate_rmse(runs["t_poses"], runs["gt"], align=False) < 0.01


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_port_follows_jax_per_frame(runs, frame):
    """Poses within 0.25 mm and 0.01 degrees of the JAX step (measured:
    1.7e-6 m at the last frame), the inlier count within 1%, ``ok`` and
    ``was_reset`` equal."""
    Tj, Tt = runs["j_poses"][frame], runs["t_poses"][frame]
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01
    aj, at = runs["j_aux"][frame], runs["t_aux"][frame]
    assert bool(at.ok) == bool(aj.ok) and bool(at.was_reset) == bool(aj.was_reset)
    assert abs(int(at.num_inliers) - int(aj.num_inliers)) <= 0.01 * int(aj.num_inliers)
    if frame:
        assert int(at.num_inliers) > 150
        assert float(at.residual) == pytest.approx(float(aj.residual), rel=1e-3)


def test_volumes_agree(runs):
    """The fused volumes after 10 frames: the weight equal and the tsdf
    within 1e-4 on 99.9% of the voxels (the poses differ by microns, a
    voxel's tsdf by that over mu = 0.04 m), the color grid within 1e-3."""
    js, ts = runs["js"], runs["ts"]
    assert (ts.weight.numpy() != np.asarray(js.weight)).mean() <= 1e-3
    assert (np.abs(ts.tsdf.numpy() - np.asarray(js.tsdf)) > 1e-4).mean() <= 1e-3
    assert (np.abs(ts.color.numpy() - np.asarray(js.color)) > 1e-3).mean() <= 1e-3
    assert float(ts.color.max()) > 0.5 and ts.color.shape == (96, 96, 96, 3)
    jv = np.any(np.asarray(js.model_points[0]) != 0, axis=-1)
    tv = torch.any(ts.model_points[0] != 0, dim=-1).numpy()
    assert jv.sum() > 2000 and (jv == tv).mean() > 0.99


def test_render_within_one_grey_level(runs):
    """``render`` of each package's own final state: uint8 [H, W, 3],
    non-constant, and within one grey level of the JAX image on 99.5% of
    the pixels (measured: 2 levels on 0.08%, where a normal lies on a
    rounding border of the shading)."""
    cfg = runs["cfg"]
    want = np.asarray(runs["jp"].render(runs["js"])).astype(np.int32)
    got = runs["tp"].render(runs["ts"])
    assert got.dtype == torch.uint8 and got.shape == (cfg.camera.height, cfg.camera.width, 3)
    assert got.numpy().std() > 5
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert (diff <= 1).mean() >= 0.995 and diff.max() <= 8


def test_render_color_matches_jax(runs):
    """``render_color``: truncating uint8, lit where the raycast hits, and
    within 2 levels of the JAX image on 99% of the pixels."""
    want = np.asarray(runs["jp"].render_color(runs["js"])).astype(np.int32)
    got = runs["tp"].render_color(runs["ts"])
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert (got.numpy().sum(-1) > 30).sum() > 1500
    assert (np.abs(got.numpy().astype(np.int32) - want) <= 2).all(-1).mean() >= 0.99


def test_render_color_without_a_color_grid_is_black(runs):
    cfg = config_from_reference(make_cfg())
    pipe = DensePipeline(cfg, device="cpu")
    state, _ = pipe.step(pipe.init(), torch.from_numpy(runs["frames"][0]))
    assert state.color.shape == (1, 1, 1, 3)
    img = pipe.render_color(state)
    assert img.dtype == torch.uint8 and not img.any()


def test_step_rgb_leaves_the_poses_alone(runs):
    """The depth-only ``step`` on a volume without color gives the poses of
    the ``step_rgb`` run to the bit."""
    pipe = DensePipeline(config_from_reference(make_cfg()), device="cpu")
    state = pipe.init()
    for f, T in zip(runs["frames"][:4], runs["t_poses"]):
        state, _ = pipe.step(state, torch.from_numpy(f))
        assert np.array_equal(state.T_wc.numpy(), T)


def test_carried_state_steps_alike(runs):
    """A JAX ``DenseState`` after CARRY_AT frames, carried into the port
    with ``convert.dense_state_from_numpy``, stepped once by each package:
    the pose within 1e-6 m, the volumes within the integrate tolerance."""
    carried = runs["carried"]
    f, c = runs["frames"][CARRY_AT], runs["rgbs"][CARRY_AT]
    js = JaxState(**{k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                         else jnp.asarray(v)) for k, v in carried.items()})
    js, ja = runs["jp"].step_rgb(js, jnp.asarray(f), jnp.asarray(c))
    ts, ta = runs["tp"].step_rgb(dense_state_from_numpy(carried, device="cpu"),
                                 torch.from_numpy(f), torch.from_numpy(c))
    assert bool(ta.ok) and bool(ja.ok)
    assert int(ta.num_inliers) == int(ja.num_inliers)
    assert np.abs(ts.T_wc.numpy() - np.asarray(js.T_wc)).max() <= 1e-6
    assert int(ts.frame) == int(js.frame) == CARRY_AT + 1
    assert (ts.weight.numpy() != np.asarray(js.weight)).mean() <= 1e-4
    assert (np.abs(ts.tsdf.numpy() - np.asarray(js.tsdf)) > 1e-5).mean() <= 1e-4
    np.testing.assert_allclose(ts.model_points[0].numpy(), np.asarray(js.model_points[0]),
                               rtol=0, atol=2e-4)
    # And back: the port's state is a JAX state again.
    back = JaxState(**{k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                           else jnp.asarray(v)) for k, v in dense_state_to_numpy(ts).items()})
    img = np.asarray(runs["jp"].render(back))
    assert img.shape == (64, 80, 3) and img.std() > 5


def test_state_round_trip_and_input_untouched(runs):
    carried = runs["carried"]
    st = dense_state_from_numpy(carried, device="cpu")
    assert isinstance(st, DenseState)
    back = dense_state_to_numpy(st)
    assert back.keys() == carried.keys() == set(DenseState._fields)
    for k, v in carried.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        back[k] if isinstance(v, tuple) else (back[k],)):
            np.testing.assert_array_equal(b, a, err_msg=k)
            assert b.dtype == a.dtype, k
    snap = [x.clone() for x in (st.tsdf, st.weight, st.color, st.T_wc)]
    runs["tp"].step_rgb(st, torch.from_numpy(runs["frames"][CARRY_AT]),
                        torch.from_numpy(runs["rgbs"][CARRY_AT]))
    runs["tp"].render(st)
    for a, b in zip(snap, (st.tsdf, st.weight, st.color, st.T_wc)):
        assert torch.equal(a, b)


def test_reset_on_garbage_frame():
    """tests/test_pipeline_dense.py::test_reset_on_garbage_frame on the
    port: an all-zero frame fails tracking, wipes the map, restarts from
    identity at frame 0, and the next frames re-bootstrap and track."""
    cfg = config_from_reference(make_cfg())
    d0 = torch.from_numpy(np.array(SyntheticScene().render_depth_mm(make_cfg().camera, jnp.eye(4))))
    pipe = DensePipeline(cfg, device="cpu")
    state, aux0 = pipe.step(pipe.init(), d0)
    assert bool(aux0.ok) and int((state.weight > 0).sum()) > 10000
    state, aux1 = pipe.step(state, torch.zeros_like(d0))
    assert not bool(aux1.ok) and bool(aux1.was_reset)
    assert int(state.resets) == 1 and int(state.frame) == 0
    assert torch.equal(state.T_wc, torch.eye(4))
    assert not state.weight.any() and bool((state.tsdf == 1).all())
    state, aux2 = pipe.step(state, d0)
    assert bool(aux2.ok) and not bool(aux2.was_reset)
    state, aux3 = pipe.step(state, d0)
    assert bool(aux3.ok) and int(aux3.num_inliers) > 150


def test_reset_off_keeps_the_map():
    cfg = config_from_reference(dataclasses.replace(make_cfg(), reset_on_failure=False))
    d0 = torch.from_numpy(np.array(SyntheticScene().render_depth_mm(make_cfg().camera, jnp.eye(4))))
    pipe = DensePipeline(cfg, device="cpu")
    state, _ = pipe.step(pipe.init(), d0)
    after, aux = pipe.step(state, torch.zeros_like(d0))
    assert not bool(aux.ok) and not bool(aux.was_reset) and int(after.resets) == 0
    assert torch.equal(after.weight, state.weight) and int(after.frame) == 2


@pytest.fixture(scope="module")
def full_march_runs(runs):
    """The first 5 frames through ``raycast.guided=False`` (the full
    160-step march) in both packages, depth only."""
    cfg = dataclasses.replace(make_cfg(), raycast=dataclasses.replace(
        make_cfg().raycast, guided=False))
    jp = JaxPipeline(cfg)
    js = jp.init()
    tp = DensePipeline(config_from_reference(cfg), device="cpu")
    ts = tp.init()
    out = []
    for f in runs["frames"][:5]:
        js, ja = jp.step(js, jnp.asarray(f))
        ts, ta = tp.step(ts, torch.from_numpy(f))
        out.append((np.asarray(js.T_wc), ts.T_wc.numpy().copy(), bool(ja.ok), bool(ta.ok),
                    int(ja.num_inliers), int(ta.num_inliers)))
    return out


@pytest.mark.parametrize("frame", range(5))
def test_full_march_model_maps_follow_jax(full_march_runs, frame):
    Tj, Tt, okj, okt, nj, nt = full_march_runs[frame]
    assert okj and okt
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01
    assert abs(nt - nj) <= 0.01 * max(nj, 1)


def test_entry_points_default_to_the_card(runs):
    """Without a device the entry points run on the card; where there is
    none they raise and never carry on on the CPU."""
    cfg = config_from_reference(make_cfg())
    assert topfusion_tpu_torch.DensePipeline is DensePipeline
    if torch.cuda.is_available():
        assert DensePipeline(cfg).device.type == "cuda"
        assert dense_state_from_numpy(runs["carried"]).tsdf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            DensePipeline(cfg)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            dense_state_from_numpy(runs["carried"])
    pipe = DensePipeline(cfg, device="cpu")
    st = pipe.init()
    assert all(x.device.type == "cpu" for x in (st.tsdf, st.color, st.T_wc, *st.model_points))
    assert st.tsdf.shape == (96, 96, 96) and len(st.model_points) == cfg.preproc.pyramid_levels
