"""Voxel reads, expected-depth ranges and the hashed-map raycast of the
port against the JAX package, on one fused map: 8 RGB-D frames of the
80x64 test orbit through the JAX ``BlockPipeline.step_rgb``, carried into
the port with ``convert.block_state_from_numpy``.

Why the raycast is held to a tolerance and not to the bit: under ``jit``
XLA's CPU backend contracts ``a + b * c`` into a fused multiply-add (in
the march's ``o + t * dir``, the crossing interpolation, the trilinear
sum) and takes 3-term dot products and norms as FMA chains; the port
rounds after every operation, on the CPU and on the card alike.  The
ranges and the voxel reads have no such expression apart from the pose
transform, so they are bit-equal wherever the pose has no rotation.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops import blockmap as jbm
from topfusion_tpu.ops import tsdf_block as jtb
from topfusion_tpu_torch.convert import block_state_from_numpy, config_from_reference
from topfusion_tpu_torch.io.synthetic import SyntheticScene as TorchScene
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import tsdf_block as ttb

torch.set_num_threads(2)

N_FRAMES = 8


def color_cfg():
    """tests/test_pipeline_block.make_cfg with the color pool on and the
    48-step ranged march of tests/test_raycast_ranges.py."""
    cfg = make_cfg()
    return dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, use_color=True),
        raycast=dataclasses.replace(cfg.raycast, ranged_max_steps=48),
    )


def jax_state_numpy(state):
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


@functools.lru_cache(maxsize=None)
def fused():
    """The JAX pipeline after N_FRAMES RGB-D frames, and the same state in
    the port (CPU).  Shared by the display, color and point-cloud tests;
    nothing in it is modified by them."""
    cfg = color_cfg()
    scene = SyntheticScene()
    gt = orbit_trajectory(N_FRAMES, max_angle_deg=4.0, max_shift=0.04, seed=3)
    jp = JaxPipeline(cfg)
    js = jp.init()
    depths, rgbs, poses = [], [], []
    for T in gt:
        Tj = jnp.asarray(T, jnp.float32)
        depths.append(np.array(scene.render_depth_mm(cfg.camera, Tj)))
        rgbs.append(np.array(scene.render_rgb(cfg.camera, Tj)))
        js, aux = jp.step_rgb(js, jnp.asarray(depths[-1]), jnp.asarray(rgbs[-1]))
        assert bool(aux.ok)
        poses.append(np.asarray(js.T_wc))
    tcfg = config_from_reference(cfg)
    return dict(
        cfg=cfg, tcfg=tcfg, gt=gt, depths=depths, rgbs=rgbs, j_poses=poses,
        jp=jp, js=js, jm=js.block_map(),
        tp=BlockPipeline(tcfg, device="cpu"),
        ts=block_state_from_numpy(jax_state_numpy(js), device="cpu"),
    )


def view_pose(name, f):
    """tracked: the pose after the last frame; novel: the off-trajectory
    pose of tests/test_raycast_ranges.py; shift: a translation only (no
    rotation, so the pose transform is exact in both packages); away:
    turned 180 degrees about x, nothing in view."""
    T = np.eye(4, dtype=np.float32)
    if name == "tracked":
        T = f["j_poses"][-1].copy()
    elif name == "novel":
        c, s = np.cos(0.12), np.sin(0.12)
        T[:3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T[:3, 3] = [0.08, -0.05, -0.06]
    elif name == "shift":
        T[:3, 3] = [0.031, -0.022, -0.043]
    elif name == "away":
        T[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return T


def both_ranges(f, T):
    cfg, tcfg = f["cfg"], f["tcfg"]
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T.copy())
    jv = jtb.visible_blocks(f["jm"], cfg.camera, cfg.tsdf, cfg.blockmap, Tj)
    tv = ttb.visible_blocks(f["ts"].block_map(), tcfg.camera, tcfg.tsdf, tcfg.blockmap, Tt)
    jr = jax.jit(lambda m, T, v: jtb.expected_depth_ranges(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, T, v,
        subsample=cfg.raycast.range_subsample))(f["jm"], Tj, jv)
    tr = ttb.expected_depth_ranges(
        f["ts"].block_map(), tcfg.camera, tcfg.tsdf, tcfg.blockmap, Tt, tv,
        subsample=tcfg.raycast.range_subsample)
    return jr, tr


# ----------------------------------------------------------------- voxel reads
def _voxel_queries(f, n=4000):
    """Voxel coords inside live blocks, around them, far away (misses) and
    negative, from a seed."""
    rng = np.random.default_rng(5)
    nb = int(f["js"].num_blocks)
    assert nb > 100
    coords = np.asarray(f["js"].block_coords)[:nb]
    base = coords[rng.integers(0, nb, size=n)] * 8
    q = base + rng.integers(-12, 20, size=(n, 3))
    q[::9] = rng.integers(-400, 400, size=q[::9].shape)
    return q.astype(np.int32)


def test_read_voxels_nearest_bit_equal():
    f = fused()
    q = _voxel_queries(f)
    bits = f["cfg"].blockmap.coord_bits
    jt, jw, jf = jbm.read_voxels_nearest(f["jm"], jnp.asarray(q), bits)
    tt, tw, tf = tbm.read_voxels_nearest(f["ts"].block_map(), torch.from_numpy(q), bits)
    assert 0.2 < np.asarray(jf).mean() < 0.95 and (q < 0).any()
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # Misses read free space.
    assert np.all(tt.numpy()[~tf.numpy()] == 1.0) and np.all(tw.numpy()[~tf.numpy()] == 0.0)


def test_read_color_nearest_bit_equal():
    f = fused()
    q = _voxel_queries(f)
    bits = f["cfg"].blockmap.coord_bits
    jc = np.asarray(jbm.read_color_nearest(f["jm"], jnp.asarray(q), bits))
    tc = tbm.read_color_nearest(f["ts"].block_map(), torch.from_numpy(q), bits).numpy()
    assert (jc > 0).any()
    np.testing.assert_array_equal(tc, jc)


def test_read_color_of_a_map_without_color_is_black():
    f = fused()
    m = f["ts"].block_map()._replace(color=torch.zeros((1, 1, 1, 1, 3), dtype=torch.int16))
    q = torch.from_numpy(_voxel_queries(f, 100))
    c = tbm.read_color_nearest(m, q, f["cfg"].blockmap.coord_bits)
    assert c.shape == (100, 3) and c.dtype == torch.float32 and not c.any()


@pytest.mark.parametrize("v", [-17, -16, -9, -8, -1, 0, 7, 8, 15])
def test_negative_voxels_floor_into_their_block(v):
    """Block and local index are by floor, not by truncation toward 0:
    voxel -1 is local 7 of block -1."""
    cfg = config_from_reference(color_cfg()).blockmap
    m = tbm.make_block_map(cfg, device="cpu")
    block = np.array([[v // 8, 0, 0]], np.int32)
    m, n = tbm.allocate(m, torch.from_numpy(block), torch.ones(1, dtype=torch.bool), cfg)
    assert int(n) == 1
    m.weight[0, v % 8, 2, 3] = 5
    t, w, found = tbm.read_voxels_nearest(
        m, torch.tensor([[v, 2, 3], [v, 2, 4]], dtype=torch.int32), cfg.coord_bits)
    assert found.tolist() == [True, True] and w.tolist() == [5.0, 0.0]


def test_sample_trilinear_matches_jax():
    """Bit-equal to the JAX function run op by op (no jit, so nothing is
    contracted), and within 1e-6 of it jitted."""
    f = fused()
    rng = np.random.default_rng(6)
    pv = (_voxel_queries(f, 3000) + rng.uniform(0, 1, size=(3000, 3))).astype(np.float32)
    bits = f["cfg"].blockmap.coord_bits
    tt, tw = tbm.sample_trilinear(f["ts"].block_map(), torch.from_numpy(pv), bits)
    jt, jw = jbm.sample_trilinear(f["jm"], jnp.asarray(pv), bits)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jt2, jw2 = jax.jit(lambda m, p: jbm.sample_trilinear(m, p, bits))(f["jm"], jnp.asarray(pv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt2), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw2))


# ----------------------------------------------------------------- ranges
@pytest.mark.parametrize("pose", ["shift", "tracked", "novel", "away"])
def test_expected_depth_ranges_match_jax(pose):
    """Bit-equal where the pose has no rotation ("shift", "away": a sign
    flip); with a rotation the corners' camera coordinates differ by an
    ulp (XLA's FMA-chain dot), so z bounds agree within 2.4e-7 m (2 ulp
    at 1 m) and a corner on a cell border may move one cell: at most 2%
    of the cells then differ by more."""
    f = fused()
    jr, tr = both_ranges(f, view_pose(pose, f))
    jr, tr = np.asarray(jr), tr.numpy()
    assert tr.shape == jr.shape == (8, 10, 2) and tr.dtype == np.float32
    if pose in ("shift", "away"):
        np.testing.assert_array_equal(tr, jr)
    else:
        assert (np.abs(tr - jr) > 2.4e-7).mean() <= 0.02
    if pose == "away":
        assert np.all(tr[..., 0] >= tr[..., 1])      # every band empty
    else:
        assert (tr[..., 0] < tr[..., 1]).mean() > 0.5


def test_ranges_bracket_the_surface():
    """The port's band holds the port's full-march depth wherever that
    hits (the form of tests/test_raycast_ranges.py)."""
    f = fused()
    tcfg = f["tcfg"]
    T = view_pose("novel", f)
    _, tr = both_ranges(f, T)
    rc = ttb.raycast_blocks(f["ts"].block_map(), tcfg.camera, tcfg.tsdf, tcfg.blockmap,
                            tcfg.raycast, torch.from_numpy(T))
    zlo = np.repeat(np.repeat(tr[..., 0].numpy(), 8, 0), 8, 1)[:64, :80]
    zhi = np.repeat(np.repeat(tr[..., 1].numpy(), 8, 0), 8, 1)[:64, :80]
    hit, d = rc.hit.numpy(), rc.depth.numpy()
    assert hit.sum() > 500
    assert np.all(d[hit] >= zlo[hit] - tcfg.tsdf.voxel_size)
    assert np.all(d[hit] <= zhi[hit] + tcfg.tsdf.voxel_size)


# ----------------------------------------------------------------- raycast
MODES = ["full", "ranged", "guided", "nearest"]


def raycast_both(f, T, mode):
    """(JAX result jitted, port result) of one raycast mode at pose T."""
    cfg, tcfg = f["cfg"], f["tcfg"]
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T.copy())
    jkw, tkw, static = {}, {}, {}
    if mode in ("ranged", "nearest"):
        jkw["range_image"], tkw["range_image"] = both_ranges(f, T)
        # The port's march gets the JAX ranges, so the two marches differ
        # only by their own arithmetic.
        tkw["range_image"] = torch.from_numpy(np.array(jkw["range_image"]))
        static["max_steps"] = cfg.raycast.ranged_max_steps
    if mode == "nearest":
        static["weight_gate"] = "nearest"
    if mode == "guided":
        d = f["depths"][-1].astype(np.float32) / np.float32(1000.0)
        jkw["expected_depth"], tkw["expected_depth"] = jnp.asarray(d), torch.from_numpy(d)
        static["depth_margin"] = cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist
        static["max_steps"] = cfg.raycast.guided_max_steps
    jrc = jax.jit(lambda m, T, kw: jtb.raycast_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T, **kw, **static))(f["jm"], Tj, jkw)
    trc = ttb.raycast_blocks(f["ts"].block_map(), tcfg.camera, tcfg.tsdf, tcfg.blockmap,
                             tcfg.raycast, Tt, **tkw, **static)
    return jrc, trc


@pytest.mark.parametrize("pose", ["tracked", "novel"])
@pytest.mark.parametrize("mode", MODES)
def test_raycast_blocks_matches_jax(mode, pose):
    """``hit`` equal on every pixel; depth and points within 1e-5 m, and
    confidence equal, on at least 99.5% of the pixels (measured: every
    pixel within 7.2e-7 m at these two poses; a ray whose sample lands an
    ulp across a voxel border reads the neighbouring voxel and may end
    1e-4 m away, see the module docstring); normals, finite differences of
    the points, within 1e-3 on 99.5%."""
    f = fused()
    jrc, trc = raycast_both(f, view_pose(pose, f), mode)
    hit = trc.hit.numpy()
    assert hit.sum() > 2000
    np.testing.assert_array_equal(hit, np.asarray(jrc.hit))
    d_err = np.abs(trc.depth.numpy() - np.asarray(jrc.depth))
    p_err = np.abs(trc.points.numpy() - np.asarray(jrc.points)).max(-1)
    n_err = np.abs(trc.normals.numpy() - np.asarray(jrc.normals)).max(-1)
    assert (d_err <= 1e-5).mean() >= 0.995, d_err.max()
    assert (p_err <= 1e-5).mean() >= 0.995, p_err.max()
    assert (n_err <= 1e-3).mean() >= 0.995, n_err.max()
    assert (trc.confidence.numpy() == np.asarray(jrc.confidence)).mean() >= 0.995
    assert trc.depth.numpy()[~hit].max() == 0.0 and not trc.points.numpy()[~hit].any()
    for t in trc:
        assert t.dtype in (torch.float32, torch.bool) and t.shape[:2] == (64, 80)


def test_raycast_looking_away_hits_nothing():
    f = fused()
    _, trc = raycast_both(f, view_pose("away", f), "ranged")
    assert not trc.hit.any() and torch.isfinite(trc.points).all()
    assert not trc.normals.any() and not trc.depth.any() and not trc.confidence.any()


def test_raycast_matches_exact_depth():
    """The port's full march against the scene's exact depth at the last
    ground-truth pose: tests/test_pipeline_block.py's form and bounds."""
    f = fused()
    tcfg = f["tcfg"]
    T = torch.from_numpy(np.array(f["gt"][-1], np.float32))
    rc = ttb.raycast_blocks(f["ts"].block_map(), tcfg.camera, tcfg.tsdf, tcfg.blockmap,
                            tcfg.raycast, T)
    gt = TorchScene().render_depth(tcfg.camera, T).numpy()
    mask = rc.hit.numpy() & (gt > 0) & (gt < 1.5)
    assert mask.mean() > 0.3
    assert np.median(np.abs(rc.depth.numpy()[mask] - gt[mask])) < 0.02


def test_ranged_raycast_matches_full_march():
    """48 ranged steps reproduce the 160-step full march from a novel
    viewpoint: tests/test_raycast_ranges.py's form and bounds."""
    f = fused()
    tcfg = f["tcfg"]
    T = view_pose("novel", f)
    m = f["ts"].block_map()
    args = (m, tcfg.camera, tcfg.tsdf, tcfg.blockmap, tcfg.raycast, torch.from_numpy(T))
    full = ttb.raycast_blocks(*args)
    _, ranges = both_ranges(f, T)
    ranged = ttb.raycast_blocks(*args, range_image=ranges,
                                max_steps=tcfg.raycast.ranged_max_steps)
    fh, rh = full.hit.numpy(), ranged.hit.numpy()
    assert (fh ^ rh).mean() < 0.02
    dd = np.abs(full.depth.numpy() - ranged.depth.numpy())[fh & rh]
    assert np.median(dd) < tcfg.tsdf.voxel_size * 0.1
    assert (dd < tcfg.tsdf.voxel_size).mean() > 0.99


def test_raycast_leaves_the_map_untouched():
    f = fused()
    m = f["ts"].block_map()
    snap = [x.clone() for x in m]
    raycast_both(f, view_pose("tracked", f), "ranged")
    assert all(torch.equal(a, b) for a, b in zip(snap, m))
