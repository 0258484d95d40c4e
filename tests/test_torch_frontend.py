"""Port vs JAX package: SE(3), camera, depth preprocessing, vertex/normal
maps, synthetic frames and ATE, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.geometry import camera as jcam
from topfusion_tpu.geometry import se3 as jse3
from topfusion_tpu.io import synthetic as jsyn
from topfusion_tpu.io import trajectory as jtraj
from topfusion_tpu.ops import depth as jdepth
from topfusion_tpu.ops import normals as jnormals
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.geometry import camera as tcam
from topfusion_tpu_torch.geometry import se3 as tse3
from topfusion_tpu_torch.io import synthetic as tsyn
from topfusion_tpu_torch.io import trajectory as ttraj
from topfusion_tpu_torch.ops import depth as tdepth
from topfusion_tpu_torch.ops import normals as tnormals

torch.set_num_threads(2)

# float32 results of the same expressions; XLA and PyTorch round their
# transcendental functions and reductions differently by an ulp or so.
POINT_TOL = 1e-6     # meters
NORMAL_TOL = 1e-5
DEPTH_TOL = 1e-6     # meters


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame():
    """One noisy 80x64 depth frame of the JAX scene, and the port config."""
    cfg = make_cfg()
    T = jsyn.orbit_trajectory(8, max_angle_deg=4.0, max_shift=0.04, seed=3)[5]
    mm = np.asarray(jsyn.SyntheticScene().render_depth_mm(cfg.camera, jnp.asarray(T)))
    return cfg, config_from_reference(cfg), jsyn.add_depth_noise(mm, 2.0, seed=1)


@pytest.mark.parametrize("scale", [1e-3, 0.1, 1.0])
def test_se3(scale):
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(16, 6)) * scale).astype(np.float32)
    pts = rng.normal(size=(16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.so3_exp(t(xi[:, :3])).numpy(), np.asarray(jse3.so3_exp(jnp.asarray(xi[:, :3]))),
        atol=1e-6)
    Tj = jse3.se3_exp(jnp.asarray(xi))
    Tt = tse3.se3_exp(t(xi))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    T = np.asarray(Tj)
    np.testing.assert_allclose(
        tse3.se3_inverse(t(T)).numpy(), np.asarray(jse3.se3_inverse(jnp.asarray(T))), atol=1e-6)
    for i in range(4):
        np.testing.assert_allclose(
            tse3.transform_points(t(T[i]), t(pts[i])).numpy(),
            np.asarray(jse3.transform_points(jnp.asarray(T[i]), jnp.asarray(pts[i]))),
            atol=1e-6)
        np.testing.assert_allclose(
            tse3.rotate_vectors(t(T[i]), t(pts[i])).numpy(),
            np.asarray(jse3.rotate_vectors(jnp.asarray(T[i]), jnp.asarray(pts[i]))),
            atol=1e-6)
    # Batched poses too.
    np.testing.assert_allclose(
        tse3.transform_points(t(T), t(pts[:, 0])).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts[:, 0]))), atol=1e-6)


def test_camera(frame):
    jc, tc, mm = frame
    cam_j, cam_t = jc.camera, tc.camera
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(100, 3)) * [0.3, 0.3, 0.2] + [0, 0, 1.0]).astype(np.float32)
    uvj, zj = jcam.project(cam_j, jnp.asarray(pts))
    uvt, zt = tcam.project(cam_t, t(pts))
    np.testing.assert_array_equal(uvt.numpy(), np.asarray(uvj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    d = rng.uniform(0.3, 2.0, size=100).astype(np.float32)
    np.testing.assert_allclose(
        tcam.backproject(cam_t, uvt, t(d)).numpy(),
        np.asarray(jcam.backproject(cam_j, uvj, jnp.asarray(d))), atol=POINT_TOL)
    depth = mm.astype(np.float32) * np.float32(0.001)
    np.testing.assert_allclose(
        tcam.backproject_grid(cam_t, t(depth)).numpy(),
        np.asarray(jcam.backproject_grid(cam_j, jnp.asarray(depth))), atol=POINT_TOL)


@pytest.mark.parametrize("reference_edges", [False, True])
def test_preprocess_depth(frame, reference_edges):
    jc, tc, mm = frame
    import dataclasses

    pj = dataclasses.replace(jc.preproc, bilateral_kernel_size=7,
                             reference_edge_semantics=reference_edges)
    pt = dataclasses.replace(tc.preproc, bilateral_kernel_size=7,
                             reference_edge_semantics=reference_edges)
    raw_j, pyr_j = jdepth.preprocess_depth(jnp.asarray(mm), pj)
    raw_t, pyr_t = tdepth.preprocess_depth(t(mm), pt)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
    assert len(pyr_t) == len(pyr_j) == 3
    for a, b in zip(pyr_t, pyr_j):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy() > 0, b > 0)
        np.testing.assert_allclose(a.numpy(), b, atol=DEPTH_TOL)


@pytest.mark.parametrize("reference_edges", [False, True])
def test_downsample_depth_odd_size(reference_edges):
    rng = np.random.default_rng(2)
    d = rng.uniform(0.5, 1.5, size=(13, 17)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = 0.0
    a = tdepth.downsample_depth(t(d), 0.04, reference_semantics=reference_edges).numpy()
    b = np.asarray(jdepth.downsample_depth(jnp.asarray(d), 0.04,
                                           reference_semantics=reference_edges))
    np.testing.assert_allclose(a, b, atol=DEPTH_TOL)


def test_maps_pyramid_and_resize(frame):
    jc, tc, mm = frame
    _, pyr_j = jdepth.preprocess_depth(jnp.asarray(mm), jc.preproc)
    pyr_np = [np.asarray(p) for p in pyr_j]
    pj, nj = jnormals.build_maps_pyramid(jc.camera, [jnp.asarray(p) for p in pyr_np])
    pt, nt = tnormals.build_maps_pyramid(tc.camera, [t(p) for p in pyr_np])
    for a, b, c, d in zip(pt, pj, nt, nj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=POINT_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(d), atol=NORMAL_TOL)
        np.testing.assert_array_equal(np.any(c.numpy() != 0, -1), np.any(np.asarray(d) != 0, -1))
    p0, n0 = np.asarray(pj[0]), np.asarray(nj[0])
    rp_j, rn_j = jnormals.resize_points_normals(jnp.asarray(p0), jnp.asarray(n0))
    rp_t, rn_t = tnormals.resize_points_normals(t(p0), t(n0))
    np.testing.assert_allclose(rp_t.numpy(), np.asarray(rp_j), atol=POINT_TOL)
    np.testing.assert_allclose(rn_t.numpy(), np.asarray(rn_j), atol=NORMAL_TOL)


def test_normals_from_point_map(frame):
    jc, _, mm = frame
    depth = mm.astype(np.float32) * np.float32(0.001)
    pts = np.asarray(jcam.backproject_grid(jc.camera, jnp.asarray(depth))) + np.float32(0.25)
    view = np.array([0.25, 0.25, 0.25], np.float32)
    a = tnormals.normals_from_point_map(t(pts), t(view)).numpy()
    b = np.asarray(jnormals.normals_from_point_map(jnp.asarray(pts), jnp.asarray(view)))
    np.testing.assert_allclose(a, b, atol=NORMAL_TOL)


@pytest.mark.parametrize("frame_idx", [0, 4])
def test_synthetic_depth_frames(frame_idx):
    """The port's sphere tracer renders the JAX scene's frames: both
    trace 128 float32 steps, so a rare pixel may round to the next
    millimetre or flip at a silhouette."""
    cfg = make_cfg()
    poses_j = jsyn.orbit_trajectory(6, max_angle_deg=4.0, max_shift=0.04, seed=3)
    poses_t = tsyn.orbit_trajectory(6, max_angle_deg=4.0, max_shift=0.04, seed=3)
    np.testing.assert_allclose(poses_t[frame_idx], poses_j[frame_idx], atol=1e-6)
    T = poses_j[frame_idx]
    a = tsyn.SyntheticScene().render_depth_mm(cfg.camera, t(T)).to(torch.int32).numpy()
    b = np.asarray(jsyn.SyntheticScene().render_depth_mm(cfg.camera, jnp.asarray(T))).astype(np.int32)
    assert a.shape == b.shape and (b > 0).mean() > 0.5
    assert (a != b).mean() <= 0.005
    both = (a > 0) & (b > 0)
    assert np.abs(a - b)[both].max() <= 1


def test_corridor_and_sweep():
    cj, ct = jsyn.corridor_scene(), tsyn.corridor_scene()
    assert (cj.spheres, cj.boxes, cj.planes) == (ct.spheres, ct.boxes, ct.planes)
    pj, pt = jsyn.sweep_trajectory(10), tsyn.sweep_trajectory(10)
    np.testing.assert_allclose(np.stack(pt), np.stack(pj), atol=1e-6)
    rng = np.random.default_rng(3)
    p = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(ct.sdf(t(p)).numpy(), np.asarray(cj.sdf(jnp.asarray(p))), atol=1e-6)
    d = rng.integers(0, 3000, size=(8, 9)).astype(np.uint16)
    np.testing.assert_array_equal(tsyn.add_depth_noise(d, 3.0, seed=4),
                                  jsyn.add_depth_noise(d, 3.0, seed=4))


@pytest.mark.parametrize("align", [False, True])
def test_ate(align):
    rng = np.random.default_rng(4)
    gt = [np.eye(4) for _ in range(6)]
    est = [np.eye(4) for _ in range(6)]
    for a, b in zip(gt, est):
        a[:3, 3] = rng.normal(size=3)
        b[:3, 3] = a[:3, 3] + rng.normal(size=3) * 0.01 + 0.2
    assert ttraj.ate_rmse(est, gt, align=align) == jtraj.ate_rmse(est, gt, align=align)
    for x, y in zip(ttraj.align_umeyama(np.stack([e[:3, 3] for e in est]),
                                        np.stack([g[:3, 3] for g in gt]), with_scale=True),
                    jtraj.align_umeyama(np.stack([e[:3, 3] for e in est]),
                                        np.stack([g[:3, 3] for g in gt]), with_scale=True)):
        np.testing.assert_array_equal(x, y)
