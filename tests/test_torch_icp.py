"""Port vs JAX package: the ICP normal equations in every gather mode,
the damped solve, and coarse-to-fine tracking against a model map the
JAX pipeline made."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.geometry.se3 import se3_exp as j_se3_exp
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops import icp as jicp
from topfusion_tpu.ops.depth import preprocess_depth as j_preprocess
from topfusion_tpu.ops.normals import build_maps_pyramid as j_maps
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.ops import icp as ticp

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def track_inputs():
    """JAX model maps after 4 frames of the test orbit (with their pose),
    and the 5th frame's vertex/normal pyramid, as numpy."""
    cfg = make_cfg()
    scene = SyntheticScene()
    poses = orbit_trajectory(8, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in poses[:5]]
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    for f in frames[:4]:
        state, _ = pipe.step(state, jnp.asarray(f))
    _, pyr = j_preprocess(jnp.asarray(frames[4]), cfg.preproc)
    cp, cn = j_maps(cfg.camera, pyr)
    npl = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return (cfg, config_from_reference(cfg), np.asarray(state.T_wc),
            npl(state.model_points), npl(state.model_normals), npl(cp), npl(cn))


MODES = [("flat", False), ("flat", True), ("take", False), ("take", True),
         ("onehot", False), ("onehot", True)]


@pytest.mark.parametrize("gather_mode,bilinear", MODES)
@pytest.mark.parametrize("level", [0, 1])
def test_normal_equations_match_jax(track_inputs, gather_mode, bilinear, level):
    """Inlier count exact; G within 1e-5 of its largest entry (float32
    sums of ~1e3 rows taken in another order; measured <= 8e-7), tighter
    than the port's 1e-4."""
    jc, tc, T_model, mp, mn, cp, cn = track_inputs
    xi = np.array([0.004, -0.003, 0.002, 0.003, -0.002, 0.004], np.float32)
    T_est = np.asarray(j_se3_exp(jnp.asarray(xi))) @ T_model
    cam_j, cam_t = jc.camera.at_level(level), tc.camera.at_level(level)
    thr = (jc.icp.dist_threshold, jc.icp.angle_threshold_cos)
    Gj, nj = jicp.build_normal_equations(
        cam_j, jnp.asarray(T_est), jnp.asarray(T_model), jnp.asarray(cp[level]),
        jnp.asarray(cn[level]), jnp.asarray(mp[level]), jnp.asarray(mn[level]),
        *thr, bilinear=bilinear, gather_mode=gather_mode)
    Gt, nt = ticp.build_normal_equations(
        cam_t, t(T_est), t(T_model), t(cp[level]), t(cn[level]), t(mp[level]),
        t(mn[level]), *thr, bilinear=bilinear, gather_mode=gather_mode)
    assert int(nt) == int(nj) > 100
    Gj = np.asarray(Gj)
    np.testing.assert_allclose(Gt.numpy(), Gj, rtol=1e-5, atol=1e-5 * np.abs(Gj).max())


def test_onehot_mode_not_ported(track_inputs):
    """The onehot mode with a band that drops correspondences, at level 0
    (margin 0 cuts at the edge between its two 32-row tiles; the default
    margin 32 makes every band of the 80x64 map the whole map) and a pose
    tilted 1.2 pixels off the model's: the same inlier count as the JAX
    package, below the flat count, and G within
    test_normal_equations_match_jax's tolerance.  At the default margin
    the port's onehot and flat modes give the same G to the bit."""
    jc, tc, T_model, mp, mn, cp, cn = track_inputs
    level = 0
    xi = np.array([0.02, -0.003, 0.002, 0.003, -0.002, 0.004], np.float32)
    T_est = np.asarray(j_se3_exp(jnp.asarray(xi))) @ T_model
    cam_j, cam_t = jc.camera.at_level(level), tc.camera.at_level(level)
    thr = (jc.icp.dist_threshold, jc.icp.angle_threshold_cos)
    Gj, nj = jicp.build_normal_equations(
        cam_j, jnp.asarray(T_est), jnp.asarray(T_model), jnp.asarray(cp[level]),
        jnp.asarray(cn[level]), jnp.asarray(mp[level]), jnp.asarray(mn[level]),
        *thr, gather_mode="onehot", onehot_v_margin=0)
    args = (cam_t, t(T_est), t(T_model), t(cp[level]), t(cn[level]), t(mp[level]),
            t(mn[level]), *thr)
    Gt, nt = ticp.build_normal_equations(*args, gather_mode="onehot", onehot_v_margin=0)
    Gf, nf = ticp.build_normal_equations(*args, gather_mode="flat")
    Gd, nd = ticp.build_normal_equations(*args, gather_mode="onehot")
    assert int(nt) == int(nj) > 100
    assert int(nt) < int(nf)
    Gj = np.asarray(Gj)
    np.testing.assert_allclose(Gt.numpy(), Gj, rtol=1e-5, atol=1e-5 * np.abs(Gj).max())
    assert int(nd) == int(nf) and torch.equal(Gd, Gf)


@pytest.mark.parametrize("count", [5, 400])
def test_solve_increment_matches_jax(track_inputs, count):
    jc, tc, T_model, mp, mn, cp, cn = track_inputs
    G, _ = jicp.build_normal_equations(
        jc.camera, jnp.asarray(T_model), jnp.asarray(T_model), jnp.asarray(cp[0]),
        jnp.asarray(cn[0]), jnp.asarray(mp[0]), jnp.asarray(mn[0]), 0.1, 0.866)
    G = np.asarray(G)
    xj, okj = jicp._solve_increment(jnp.asarray(G), jnp.asarray(count, jnp.int32), jc.icp)
    xt, okt = ticp._solve_increment(t(G), torch.tensor(count, dtype=torch.int32), tc.icp)
    assert bool(okt) == bool(okj) == (count >= jc.icp.min_corresp)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6)
    # A singular system fails without raising.
    xs, oks = ticp._solve_increment(torch.zeros(7, 7), torch.tensor(400, dtype=torch.int32), tc.icp)
    assert not bool(oks) and torch.equal(xs, torch.zeros(6))


@pytest.mark.parametrize("variant", ["flat_polish", "take_bilinear_stride1", "onehot_polish"])
def test_icp_track_matches_jax(track_inputs, variant):
    """Tracking from the model pose to the 5th frame: poses within 1e-6 m
    and 1e-6 rad (measured <= 2e-7; the port allows 1e-4): the
    per-iteration G differs in its last bits, and 13 Gauss-Newton steps
    carry that on."""
    jc, tc, T_model, mp, mn, cp, cn = track_inputs
    icfg = jc.icp
    if variant == "take_bilinear_stride1":
        icfg = dataclasses.replace(icfg, gather_mode="take", bilinear=True, level0_stride=1)
    if variant == "onehot_polish":
        icfg = dataclasses.replace(icfg, gather_mode="onehot")
    tcfg_icp = config_from_reference(dataclasses.replace(jc, icp=icfg)).icp
    rj = jicp.icp_track(jc.camera, icfg, jnp.asarray(T_model), jnp.asarray(T_model),
                        [jnp.asarray(x) for x in cp], [jnp.asarray(x) for x in cn],
                        [jnp.asarray(x) for x in mp], [jnp.asarray(x) for x in mn])
    rt = ticp.icp_track(tc.camera, tcfg_icp, t(T_model), t(T_model),
                        [t(x) for x in cp], [t(x) for x in cn],
                        [t(x) for x in mp], [t(x) for x in mn])
    assert bool(rt.ok) and bool(rj.ok)
    Tj, Tt = np.asarray(rj.T_wc), rt.T_wc.numpy()
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-6
    assert np.abs(Tt[:3, :3] - Tj[:3, :3]).max() <= 1e-6
    assert np.abs(Tj[:3, 3] - T_model[:3, 3]).max() > 1e-3  # the frame moved
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=1e-4)
    np.testing.assert_allclose(float(ticp.obs_ratio(rt.gram)), float(rj.obs_ratio), rtol=1e-4)
    assert rt.num_inliers.dtype == torch.int32 and rt.ok.dtype == torch.bool
