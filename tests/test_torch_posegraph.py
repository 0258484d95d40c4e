"""The port's pose graph (``topfusion_tpu_torch/models/posegraph.py``) and
its SE(3) log against the JAX package on the CPU, on the inputs of
tests/test_posegraph.py (the 80x64 camera, keyframe maps at level 1)
made from seeded numpy, carried between the packages by ``convert``.

Tolerances, and why:
* ``se3_log``: XLA's CPU ``sin``, ``atan2`` and ``sqrt`` differ from
  PyTorch's by an ulp on some inputs, so the twists agree within 4 ulps
  of the twist's largest component, not to the bit.
* ``kf_descriptor``: an ``atan2`` an ulp apart moves a pixel across a
  bin edge, so each histogram's counts agree within two pixels.
* ``detect_loop``: the same loops, edges and flags; the measured
  transforms within 1e-5; the inlier counts within the first row and
  column of the strided grid, which an exact revisit projects to
  u or v = 0 +- 1 ulp (in bounds in one package, out in the other).
* ``edge_jacobians`` and ``optimize``: float32 sums in another order
  (matmul and incidence products here, scatter-adds there): 2e-6 on the
  Jacobians, 1e-5 m / rad on the optimized poses.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topfusion_tpu.config import CameraConfig, ICPConfig, PipelineConfig, PoseGraphConfig
from topfusion_tpu.geometry import se3 as jse3
from topfusion_tpu.io.synthetic import SyntheticScene
from topfusion_tpu.models import posegraph as jpg
from topfusion_tpu.ops.normals import compute_points_normals
from topfusion_tpu_torch.convert import (
    config_from_reference,
    pose_graph_from_numpy,
    pose_graph_to_numpy,
)
from topfusion_tpu_torch.geometry import se3 as tse3
from topfusion_tpu_torch.models import posegraph as tpg

torch.set_num_threads(2)

CAM = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
CAM_L = CAM.at_level(1)
ICP_CFG = ICPConfig()
SCENE = SyntheticScene()


def port(pg_cfg):
    """The port's (camera at level 1, posegraph, icp) configs."""
    c = config_from_reference(PipelineConfig(camera=CAM, icp=ICP_CFG, posegraph=pg_cfg))
    return c.camera.at_level(1), c.posegraph, c.icp


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def carry(pg) -> tpg.PoseGraph:
    return pose_graph_from_numpy({k: np.asarray(v) for k, v in pg._asdict().items()}, "cpu")


@functools.lru_cache(maxsize=None)
def kf_maps(x: float):
    """Level-1 camera-space maps of the keyframe at x metres along x."""
    T = jse3.se3_exp(jnp.asarray([0, 0, 0, x, 0, 0], jnp.float32))
    p, n = compute_points_normals(CAM_L, SCENE.render_depth(CAM_L, T))
    return np.asarray(T), np.asarray(p), np.asarray(n)


def build(pg_cfg, xs, do_add=None):
    """The same keyframes inserted into a JAX graph and a port graph."""
    do_add = do_add or [True] * len(xs)
    cam_l, tcfg, _ = port(pg_cfg)
    jg = jpg.make_pose_graph(pg_cfg, CAM_L)
    tg = tpg.make_pose_graph(tcfg, cam_l, device="cpu")
    for i, (x, add) in enumerate(zip(xs, do_add)):
        T, p, n = kf_maps(x)
        jg = jpg.add_keyframe(jg, jnp.asarray(T), jnp.asarray(p), jnp.asarray(n),
                              jnp.asarray(i), jnp.asarray(add))
        tg = tpg.add_keyframe(tg, t(T), t(p), t(n), i, add)
    return jg, tg


def assert_graphs_equal(got: tpg.PoseGraph, want, float_atol=0.0, desc_pixels=0):
    for name in tpg.PoseGraph._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "kf_desc":
            # In pixels: each histogram is normalized by the valid count.
            n_valid = (np.asarray(want.kf_points) != 0).any(-1).sum((1, 2))
            assert (np.abs(g - w) * n_valid[:, None] <= desc_pixels + 1e-3).all(), name
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=float_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ----------------------------------------------------------------- SE(3)
@pytest.mark.parametrize("scale", [0.5, 1e-3, 0.0], ids=["large", "small", "zero"])
def test_se3_log_within_ulps_of_jax(scale):
    rng = np.random.default_rng(7)
    xi = (rng.normal(0, 1, (300, 6)) * scale).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    want = np.asarray(jse3.se3_log(jnp.asarray(T)))
    got = tse3.se3_log(t(T)).numpy()
    big = np.maximum(np.abs(want).max(axis=1, keepdims=True), np.float32(1e-30))
    assert (np.abs(got - want) <= 4 * np.spacing(big.astype(np.float32))).all()
    np.testing.assert_allclose(got, xi, rtol=0, atol=1e-5)   # the exp map's inverse
    w_want = np.asarray(jse3.so3_log(jnp.asarray(T[:, :3, :3])))
    w_got = tse3.so3_log(t(T[:, :3, :3])).numpy()
    big = np.maximum(np.abs(w_want).max(axis=1, keepdims=True), np.float32(1e-30))
    assert (np.abs(w_got - w_want) <= 4 * np.spacing(big.astype(np.float32))).all()


def test_se3_log_traces_under_jacfwd_and_vmap():
    """d log(exp(x) T) / dx at x = 0 through torch.func, against jax.jacfwd."""
    rng = np.random.default_rng(8)
    T = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.4, (20, 6)), jnp.float32)))

    def jres(x, T):
        return jse3.se3_log(jse3.se3_exp(x) @ T)

    def tres(x, T):
        return tse3.se3_log(tse3.se3_exp(x) @ T)

    want = np.asarray(jax.vmap(jax.jacfwd(jres))(jnp.zeros((20, 6)), jnp.asarray(T)))
    got = torch.func.vmap(torch.func.jacfwd(tres))(torch.zeros(20, 6), t(T)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# ----------------------------------------------------------------- insert
def test_kf_descriptor_matches_jax():
    for x in (0.0, 0.1, -0.07):
        _, p, n = kf_maps(x)
        want = np.asarray(jpg.kf_descriptor(jnp.asarray(p), jnp.asarray(n)))
        got = tpg.kf_descriptor(t(p), t(n)).numpy()
        n_valid = float((np.abs(p) > 0).any(-1).sum())
        for lo, hi in ((0, 16), (16, 24), (24, 28)):
            assert np.abs(got[lo:hi] - want[lo:hi]).sum() * n_valid <= 2 + 1e-3
        np.testing.assert_allclose([got[:16].sum(), got[16:24].sum(), got[24:].sum()], 1, atol=1e-6)


def test_add_keyframe_matches_jax():
    """tests/test_posegraph.py's odometry chain, one masked insert among
    them, then past capacity: every field as JAX's."""
    cfg = PoseGraphConfig(max_keyframes=5, max_edges=4, gn_iters=8)
    xs = [0.0, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06]
    jg, tg = build(cfg, xs, do_add=[True, True, False, True, True, True, True])
    assert int(tg.num_kf) == 5 and int(tg.num_edges) == 4
    assert_graphs_equal(tg, jg, float_atol=1e-7, desc_pixels=2)
    np.testing.assert_allclose(tg.edge_T[0, :3, 3].numpy(), [0.01, 0, 0], atol=1e-6)


def test_add_keyframe_masked_writes_nothing():
    cfg = PoseGraphConfig(max_keyframes=16, max_edges=64, gn_iters=8)
    jg, tg = build(cfg, [0.0], do_add=[False])
    assert int(tg.num_kf) == 0 and int(tg.num_edges) == 0
    assert not bool(tg.kf_points.any())
    assert_graphs_equal(tg, jg)


# ----------------------------------------------------------------- loops
REVISIT = PoseGraphConfig(max_keyframes=16, max_edges=64, loop_candidate_window=3,
                          loop_max_dist=0.5, gn_iters=5)
FAR = PoseGraphConfig(max_keyframes=16, max_edges=64, loop_candidate_window=2,
                      loop_max_dist=0.05)


@functools.lru_cache(maxsize=None)
def loops(case: str):
    """detect_loop of both packages on tests/test_posegraph.py's revisit
    (8 keyframes 15 cm out and back) or far walk (6 keyframes 20 cm apart):
    (JAX result, port result, keyframe poses)."""
    cfg = REVISIT if case == "revisit" else FAR
    if case == "revisit":
        xs = [0.05 * i if i < 4 else 0.05 * (7 - i) for i in range(8)]
    else:
        xs = [0.2 * i for i in range(6)]
    jg, _ = build(cfg, xs)
    want = jax.jit(lambda g: jpg.detect_loop(g, CAM_L, cfg, ICP_CFG))(jg)
    cam_l, tcfg, ticp = port(cfg)
    got = tpg.detect_loop(carry(jg), cam_l, tcfg, ticp)
    return want, got, [kf_maps(x)[0] for x in xs]


@pytest.mark.parametrize("case", ["revisit", "far"])
def test_detect_loop_matches_jax(case):
    (jg, jfound, jinfo), (tg, tfound, tinfo), _ = loops(case)
    assert bool(tfound) == bool(jfound) == (case == "revisit")
    assert_graphs_equal(tg, jg, float_atol=1e-5, desc_pixels=0)
    assert int(tinfo.n_closed) == int(jinfo.n_closed)
    edge_rows = CAM_L.height // 2 + CAM_L.width // 2 - 1
    assert abs(int(tinfo.inliers) - int(jinfo.inliers)) <= edge_rows
    if case == "revisit":
        assert float(tinfo.residual) < 1e-3 and float(jinfo.residual) < 1e-3
    else:
        assert int(tinfo.inliers) == -1 and float(tinfo.residual) == float("inf")


def test_detect_loop_passes_the_jax_tests_own_checks():
    """tests/test_posegraph.py::test_detect_loop_on_revisit on the port."""
    _, (pg, found, info), poses = loops("revisit")
    assert bool(found)
    n_e = int(pg.num_edges)
    e = [e for e in range(n_e) if bool(pg.edge_is_loop[e]) and int(pg.edge_j[e]) == 7][0]
    assert int(pg.edge_i[e]) <= 2 and bool(pg.kf_loop_done[7])
    assert int(info.n_closed) >= 1 and int(info.inliers) > 0
    assert float(info.residual) < REVISIT.huber_delta
    T_true = np.linalg.inv(poses[int(pg.edge_i[e])]) @ poses[7]
    np.testing.assert_allclose(pg.edge_T[e].numpy(), T_true, atol=5e-3)


# ----------------------------------------------------------------- solve
def test_edge_jacobians_match_jax():
    rng = np.random.default_rng(3)
    poses = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.3, (16, 6)), jnp.float32)))
    ei = rng.integers(0, 16, 40).astype(np.int32)
    ej = rng.integers(0, 16, 40).astype(np.int32)
    eT = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.3, (40, 6)), jnp.float32)))
    want = jpg.edge_jacobians(*(jnp.asarray(a) for a in (poses, ei, ej, eT)))
    got = tpg.edge_jacobians(*(t(a) for a in (poses, ei, ej, eT)))
    for name, g, w in zip("rAB", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6, err_msg=name)


def drift_graph():
    """tests/test_posegraph.py::test_optimize_corrects_drift's graph (JAX)."""
    cfg = PoseGraphConfig(max_keyframes=16, max_edges=64, gn_iters=8)
    pg = jpg.make_pose_graph(cfg, CAM_L)
    _, p, n = kf_maps(0.0)
    true = [jse3.se3_exp(jnp.asarray([0, 0, 0, 0.05 * i, 0, 0], jnp.float32)) for i in range(6)]
    drift = [jse3.se3_exp(jnp.asarray([0, 0, 0, 0.05 * i, 0.01 * i, 0], jnp.float32))
             for i in range(6)]
    for i in range(6):
        pg = jpg.add_keyframe(pg, drift[i], jnp.asarray(p), jnp.asarray(n), jnp.asarray(i),
                              jnp.asarray(True))
    eT = pg.edge_T
    for e in range(5):
        eT = eT.at[e].set(jse3.se3_inverse(true[e]) @ true[e + 1])
    pg = pg._replace(
        edge_T=eT.at[5].set(jse3.se3_inverse(true[0]) @ true[5]),
        edge_i=pg.edge_i.at[5].set(0), edge_j=pg.edge_j.at[5].set(5),
        edge_is_loop=pg.edge_is_loop.at[5].set(True),
        num_edges=jnp.asarray(6, jnp.int32),
    )
    return cfg, pg, [np.asarray(T) for T in true], np.asarray(drift[0])


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_optimize_matches_jax(solver):
    """Both solvers on the drift graph carried over: the poses and chi2 as
    JAX's, and the JAX test's own checks on the port's result."""
    cfg, pg, true, anchor = drift_graph()
    cfg = dataclasses.replace(cfg, solver=solver)
    want, wchi = jax.jit(lambda g: jpg.optimize(g, cfg))(pg)
    tg = carry(pg)
    got, chi = tpg.optimize(tg, port(cfg)[1])
    np.testing.assert_allclose(got.kf_poses.numpy(), np.asarray(want.kf_poses), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(chi), float(wchi), rtol=0, atol=1e-8)
    zero = torch.zeros(16, 6)
    r0 = float(torch.linalg.vector_norm(tpg.edge_residuals(zero, tg)))
    r1 = float(torch.linalg.vector_norm(tpg.edge_residuals(zero, got)))
    assert r1 < r0 * 0.05, (r0, r1)
    np.testing.assert_allclose(got.kf_poses[0].numpy(), anchor, atol=1e-5)
    for i in range(6):
        assert np.linalg.norm(got.kf_poses[i, :3, 3].numpy() - true[i][:3, 3]) < 5e-3
    # Nothing but the poses changed.
    for name in tpg.PoseGraph._fields[1:]:
        assert torch.equal(getattr(got, name), getattr(tg, name)), name


# ----------------------------------------------------------------- carry
def test_pose_graph_round_trips_between_packages():
    """JAX -> port -> numpy and port -> JAX -> numpy, field for field."""
    (jg, _, _), (tg, _, _), _ = loops("revisit")
    back = pose_graph_to_numpy(carry(jg))
    for name in jpg.PoseGraph._fields:
        w = np.asarray(getattr(jg, name))
        assert back[name].dtype == w.dtype
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    as_jax = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in pose_graph_to_numpy(tg).items()})
    for name in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(np.asarray(getattr(as_jax, name)),
                                      getattr(tg, name).numpy(), err_msg=name)


def test_make_pose_graph_defaults_to_the_card():
    cam_l, tcfg, _ = port(REVISIT)
    if torch.cuda.is_available():
        assert tpg.make_pose_graph(tcfg, cam_l).kf_poses.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tpg.make_pose_graph(tcfg, cam_l)
