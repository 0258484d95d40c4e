"""The slice end to end: the port's BlockPipeline against the JAX
package's on the 8-frame test orbit (splat model maps, and the guided and
full raycast model maps), a JAX state carried over into the port
mid-sequence, and reset on a garbage frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu_torch.convert import (
    block_state_from_numpy,
    block_state_to_numpy,
    config_from_reference,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline

torch.set_num_threads(2)

N_FRAMES = 8
CARRY_AT = 4


def jax_state_numpy(state):
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


def rot_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees, from its skew part (arccos of the trace
    loses small angles to float32 rounding)."""
    M = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0))))


@pytest.fixture(scope="module")
def runs():
    """Both pipelines over the orbit of tests/test_pipeline_block.py, plus
    the JAX state after CARRY_AT frames."""
    cfg = make_cfg()
    scene = SyntheticScene()
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [np.array(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in gt]
    jp = JaxPipeline(cfg)
    js = jp.init()
    j_poses, j_aux, carried = [], [], None
    for i, f in enumerate(frames):
        if i == CARRY_AT:
            carried = jax_state_numpy(js)
        js, aux = jp.step(js, jnp.asarray(f))
        j_poses.append(np.asarray(js.T_wc))
        j_aux.append(jax.tree.map(np.asarray, aux))
    tp = BlockPipeline(config_from_reference(cfg), device="cpu")
    ts = tp.init()
    t_poses, t_aux = [], []
    for f in frames:
        ts, aux = tp.step(ts, torch.from_numpy(f))
        t_poses.append(ts.T_wc.numpy().copy())
        t_aux.append(aux)
    return dict(cfg=cfg, gt=gt, frames=frames, jp=jp, tp=tp, ts=ts,
                j_poses=j_poses, j_aux=j_aux, t_poses=t_poses, t_aux=t_aux,
                carried=carried)


def test_port_tracks_every_frame(runs):
    assert all(bool(a.ok) for a in runs["t_aux"])
    assert int(runs["ts"].resets) == 0
    assert not any(bool(a.was_reset) for a in runs["t_aux"])
    assert all(int(a.integrate_skipped) == 0 for a in runs["t_aux"])


def test_port_ate_bound(runs):
    """The JAX test's bound (tests/test_pipeline_block.py)."""
    assert ate_rmse(runs["t_poses"], runs["gt"], align=False) < 0.012


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_port_follows_jax_per_frame(runs, frame):
    """Poses within 0.25 mm and 0.01 degrees of the JAX package's (measured
    0.07 mm at the last frame; the port allows 1 mm / 0.1 degrees): ulp
    differences in ICP's sums feed back through the model maps.  Block
    allocation and the visible set agree exactly."""
    Tj, Tt = runs["j_poses"][frame], runs["t_poses"][frame]
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01
    aj, at = runs["j_aux"][frame], runs["t_aux"][frame]
    assert bool(at.ok) == bool(aj.ok)
    for name in ("num_blocks", "blocks_allocated", "num_visible", "blocks_dropped",
                 "visible_overflow"):
        assert int(getattr(at, name)) == int(getattr(aj, name)), name


def test_carried_state_steps_alike(runs):
    """A JAX state after CARRY_AT frames, carried into the port, steps to
    within 0.5 mm of the JAX step on the next frame, with the same map."""
    carried, cfg = runs["carried"], runs["cfg"]
    f = runs["frames"][CARRY_AT]
    js = runs["jp"].init()._replace(**{
        k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
        for k, v in carried.items()})
    js, ja = runs["jp"].step(js, jnp.asarray(f))
    ts, ta = runs["tp"].step(block_state_from_numpy(carried, device="cpu"), torch.from_numpy(f))
    assert bool(ta.ok) and bool(ja.ok)
    assert np.abs(ts.T_wc.numpy()[:3, 3] - np.asarray(js.T_wc)[:3, 3]).max() <= 5e-4
    assert int(ts.num_blocks) == int(js.num_blocks)
    np.testing.assert_array_equal(ts.block_coords.numpy(), np.asarray(js.block_coords))
    np.testing.assert_array_equal(ts.bucket_keys.numpy(), np.asarray(js.bucket_keys))
    np.testing.assert_array_equal(ts.vis_slots.numpy(), np.asarray(js.vis_slots))
    assert int(ts.frame) == int(js.frame) == CARRY_AT + 1


def test_state_round_trip_and_input_untouched(runs):
    carried = runs["carried"]
    st = block_state_from_numpy(carried, device="cpu")
    back = block_state_to_numpy(st)
    assert back.keys() == carried.keys()
    for k, v in carried.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        back[k] if isinstance(v, tuple) else (back[k],)):
            np.testing.assert_array_equal(b, a, err_msg=k)
            assert b.dtype == a.dtype, k
    snap = [x.clone() for x in (st.tsdf, st.weight, st.bucket_keys, st.T_wc)]
    runs["tp"].step(st, torch.from_numpy(runs["frames"][CARRY_AT]))
    for a, b in zip(snap, (st.tsdf, st.weight, st.bucket_keys, st.T_wc)):
        assert torch.equal(a, b)


def test_reset_on_garbage_frame():
    cfg = config_from_reference(make_cfg())
    scene = SyntheticScene()
    d0 = torch.from_numpy(np.array(scene.render_depth_mm(make_cfg().camera, jnp.eye(4))))
    pipe = BlockPipeline(cfg, device="cpu")
    state, aux0 = pipe.step(pipe.init(), d0)
    assert bool(aux0.ok) and int(state.num_blocks) > 0
    state, aux1 = pipe.step(state, torch.zeros_like(d0))
    assert not bool(aux1.ok) and bool(aux1.was_reset)
    assert int(state.num_blocks) == 0 and int(state.frame) == 0 and int(state.resets) == 1
    assert torch.equal(state.T_wc, torch.eye(4))
    assert int((state.weight != 0).sum()) == 0
    state, aux2 = pipe.step(state, d0)
    assert bool(aux2.ok) and int(state.num_blocks) > 0


def test_integrate_paths_agree_on_cpu(runs):
    """use_pallas_integrate False (plain), None (plain on the CPU) and True
    (the kernel wrapper, plain on CPU tensors) give the same step."""
    cfg = make_cfg()

    def pipe(value):
        return BlockPipeline(config_from_reference(dataclasses.replace(
            cfg, blockmap=dataclasses.replace(cfg.blockmap, use_pallas_integrate=value))),
            device="cpu")

    st = block_state_from_numpy(runs["carried"], device="cpu")
    f = torch.from_numpy(runs["frames"][CARRY_AT])
    a, _ = pipe(False).step(st, f)
    b, _ = runs["tp"].step(st, f)
    c, _ = pipe(True).step(st, f)
    for x in (b, c):
        assert torch.equal(a.tsdf, x.tsdf) and torch.equal(a.T_wc, x.T_wc)


@pytest.mark.parametrize("change", ["icp_onehot"])
def test_unported_options_raise(runs, change):
    """ICP's onehot gather mode, which the port once refused, steps as the
    JAX package's: 3 frames from the JAX state after CARRY_AT frames,
    each started from the JAX state carried into the port, with poses
    within test_port_follows_jax_per_frame's 0.25 mm and 0.01 degrees and
    the same blocks allocated and visible."""
    cfg = make_cfg()
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, gather_mode="onehot"))
    jp = JaxPipeline(cfg)
    tp = BlockPipeline(config_from_reference(cfg), device="cpu")
    js = runs["jp"].init()._replace(**{
        k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
        for k, v in runs["carried"].items()})
    for f in runs["frames"][CARRY_AT:CARRY_AT + 3]:
        ts, ta = tp.step(block_state_from_numpy(jax_state_numpy(js), device="cpu"),
                         torch.from_numpy(f))
        js, ja = jp.step(js, jnp.asarray(f))
        Tj, Tt = np.asarray(js.T_wc), ts.T_wc.numpy()
        assert bool(ta.ok) and bool(ja.ok)
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
        assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01
        assert int(ta.num_inliers) > 100
        for name in ("num_blocks", "blocks_allocated", "num_visible", "blocks_dropped",
                     "visible_overflow"):
            assert int(getattr(ta, name)) == int(getattr(ja, name)), name


def raycast_cfg(guided):
    cfg = make_cfg()
    return dataclasses.replace(cfg, raycast=dataclasses.replace(
        cfg.raycast, model_maps="raycast", guided=guided))


@pytest.fixture(scope="module", params=["guided", "full"])
def raycast_runs(request, runs):
    """The 8 frames through ``model_maps="raycast"`` in both packages:
    the guided 24-step band, or the full 160-step march."""
    cfg = raycast_cfg(request.param == "guided")
    jp = JaxPipeline(cfg)
    js = jp.init()
    tp = BlockPipeline(config_from_reference(cfg), device="cpu")
    ts = tp.init()
    j_poses, t_poses, j_aux, t_aux = [], [], [], []
    for f in runs["frames"]:
        js, ja = jp.step(js, jnp.asarray(f))
        ts, ta = tp.step(ts, torch.from_numpy(f))
        j_poses.append(np.asarray(js.T_wc))
        t_poses.append(ts.T_wc.numpy().copy())
        j_aux.append(jax.tree.map(np.asarray, ja))
        t_aux.append(ta)
    return dict(j_poses=j_poses, t_poses=t_poses, j_aux=j_aux, t_aux=t_aux, js=js, ts=ts)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_raycast_model_maps_follow_jax_per_frame(raycast_runs, frame):
    """The raycast-model-map step follows the JAX step as the splat step
    does: poses within 0.25 mm and 0.01 degrees (the splat step measures
    0.07 mm), the same blocks allocated and visible."""
    r = raycast_runs
    Tj, Tt = r["j_poses"][frame], r["t_poses"][frame]
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01
    aj, at = r["j_aux"][frame], r["t_aux"][frame]
    assert bool(at.ok) and bool(aj.ok)
    for name in ("num_blocks", "blocks_allocated", "num_visible", "blocks_dropped",
                 "visible_overflow"):
        assert int(getattr(at, name)) == int(getattr(aj, name)), name


def test_raycast_model_maps_track(raycast_runs, runs):
    r = raycast_runs
    assert int(r["ts"].resets) == 0
    assert ate_rmse(r["t_poses"], runs["gt"], align=False) < 0.012
    # Model maps: a hit where the JAX step has one, on 99% of the pixels.
    jv = np.any(np.asarray(r["js"].model_points[0]) != 0, axis=-1)
    tv = torch.any(r["ts"].model_points[0] != 0, dim=-1).numpy()
    assert jv.sum() > 2000 and (jv == tv).mean() > 0.99


def test_depth_only_step_ignores_a_color_pool(runs):
    """``step`` without rgb on a ``use_color`` map: the same poses and TSDF
    pool as without the pool, and the color pool stays empty."""
    cfg = make_cfg()
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=True))
    pipe = BlockPipeline(config_from_reference(cfg), device="cpu")
    state = pipe.init()
    for f, T in zip(runs["frames"][:3], runs["t_poses"]):
        state, _ = pipe.step(state, torch.from_numpy(f))
        assert np.array_equal(state.T_wc.numpy(), T)
    assert state.color.shape == (cfg.blockmap.capacity + 1, 8, 8, 8, 3) and not state.color.any()


def test_entry_points_default_to_the_card(runs):
    """Without a device the entry points run on the card; where there is
    none they raise and never carry on on the CPU.  Asked for the CPU by
    name they run there."""
    cfg = config_from_reference(make_cfg())
    if torch.cuda.is_available():
        assert BlockPipeline(cfg).device.type == "cuda"
        assert block_state_from_numpy(runs["carried"]).tsdf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            BlockPipeline(cfg)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            block_state_from_numpy(runs["carried"])
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            BlockPipeline(cfg, device="cuda:0")
    pipe = BlockPipeline(cfg, device="cpu")
    assert pipe.device == torch.device("cpu")
    assert pipe.init().tsdf.device.type == "cpu"
    st = block_state_from_numpy(runs["carried"], device="cpu")
    assert all(x.device.type == "cpu" for x in (st.tsdf, st.T_wc, *st.model_points))
