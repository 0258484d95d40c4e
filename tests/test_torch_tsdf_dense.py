"""The dense volume of the port (``ops/tsdf_dense.py``) against the JAX
package's, on a 64^3 volume fused from 4 RGB-D frames of the 80x64 test
orbit.

Which JAX the port is held to.  Run op by op (``jax.disable_jit()``) the
JAX functions round after every operation, as the port does, except in
the pose transform: an einsum, which XLA's CPU backend takes as an FMA
chain even alone.  So the port is BIT-EQUAL to the eager JAX function at
poses without rotation (the transform is then exact in both), and within
a stated tolerance at rotated poses and of the jitted function, where XLA
also contracts ``a * b + c``.  A voxel's camera depth moves by an ulp or
two (2.4e-7 m at 1-2 m), the fused value by that over mu.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topfusion_tpu.config import (
    CameraConfig,
    DenseVolumeConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.ops import tsdf_dense as jd
from topfusion_tpu.ops.depth import depth_to_meters
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.ops import tsdf_dense as td

torch.set_num_threads(2)

MU = 0.06
# One ulp of a camera depth of 2 m (2.4e-7 m) moves eta / mu by 4e-6.
TSDF_TOL = 2 * 2.4e-7 / MU


def make_cfg(**tsdf_kw):
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        dense=DenseVolumeConfig(dims=(64, 64, 64), origin=(-0.48, -0.48, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.015, trunc_dist=MU, **tsdf_kw),
        raycast=RaycastConfig(max_steps=120),
    )


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def pose(name) -> np.ndarray:
    """identity; shift: a translation only (the pose transform is exact in
    both packages); rot: frame 2 of the orbit; novel: off the orbit; away:
    turned 180 degrees about x."""
    T = np.eye(4, dtype=np.float32)
    if name == "shift":
        T[:3, 3] = [0.031, -0.022, -0.043]
    elif name == "rot":
        T = np.asarray(orbit_trajectory(4, 4.0, 0.04, seed=3)[2], np.float32)
    elif name == "novel":
        c, s = np.cos(0.12), np.sin(0.12)
        T[:3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T[:3, 3] = [0.08, -0.05, -0.06]
    elif name == "away":
        T[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return T


@functools.lru_cache(maxsize=None)
def fused():
    """The JAX volume and color grid after 4 frames at the ground-truth
    poses (jitted), and the same in the port."""
    cfg = make_cfg()
    scene = SyntheticScene()
    vol = jd.make_dense_volume(cfg.dense)
    col = jd.make_color_volume(cfg.dense, True)
    step = jax.jit(lambda v, c, T, d, rgb: (
        (v2 := jd.integrate_dense(v, cfg.camera, cfg.tsdf, cfg.dense, T, d)),
        jd.integrate_color_dense(c, v2, cfg.camera, cfg.tsdf, cfg.dense, T, d, rgb)))
    for T in orbit_trajectory(4, 4.0, 0.04, seed=3):
        Tj = jnp.asarray(T, jnp.float32)
        d = depth_to_meters(scene.render_depth_mm(cfg.camera, Tj))
        vol, col = step(vol, col, Tj, d, scene.render_rgb(cfg.camera, Tj))
    tvol = td.DenseVolume(t(vol.tsdf), t(vol.weight))
    return dict(cfg=cfg, tcfg=config_from_reference(cfg), scene=scene,
                vol=vol, col=col, tvol=tvol, tcol=t(col))


def frame_at(T):
    f = fused()
    Tj = jnp.asarray(T)
    d = depth_to_meters(f["scene"].render_depth_mm(f["cfg"].camera, Tj))
    return d, f["scene"].render_rgb(f["cfg"].camera, Tj)


def integrate_both(T, mode, cfg=None, rgb_float=False):
    """((jax volume, jax color), (port volume, port color)) of one more
    frame at pose T fused into the fused volume; ``mode`` eager or jit."""
    f = fused()
    cfg = cfg or f["cfg"]
    tcfg = config_from_reference(cfg)
    d, rgb = frame_at(T)
    if rgb_float:
        rgb = rgb.astype(jnp.float32) / 255.0

    def run(v, c, T, d, rgb):
        v2 = jd.integrate_dense(v, cfg.camera, cfg.tsdf, cfg.dense, T, d)
        return v2, jd.integrate_color_dense(c, v2, cfg.camera, cfg.tsdf, cfg.dense, T, d, rgb)

    if mode == "eager":
        with jax.disable_jit():
            want = run(f["vol"], f["col"], jnp.asarray(T), d, rgb)
    else:
        want = jax.jit(run)(f["vol"], f["col"], jnp.asarray(T), d, rgb)
    v2 = td.integrate_dense(f["tvol"], tcfg.camera, tcfg.tsdf, tcfg.dense, t(T), t(d))
    c2 = td.integrate_color_dense(f["tcol"], v2, tcfg.camera, tcfg.tsdf, tcfg.dense,
                                  t(T), t(d), t(rgb))
    return want, (v2, c2)


# ----------------------------------------------------------------- integrate
@pytest.mark.parametrize("name", ["identity", "shift"])
def test_integrate_dense_bit_equal_to_eager_jax(name):
    (jv, _), (tv, _) = integrate_both(pose(name), "eager")
    f = fused()
    assert int((tv.weight != f["tvol"].weight).sum()) > 50000
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    np.testing.assert_array_equal(tv.tsdf.numpy(), np.asarray(jv.tsdf))
    assert tv.tsdf.dtype == torch.float32 and tv.tsdf.shape == (64, 64, 64)


@pytest.mark.parametrize("rgb_float", [False, True], ids=["uint8", "float"])
@pytest.mark.parametrize("name", ["identity", "shift"])
def test_integrate_color_dense_bit_equal_to_eager_jax(name, rgb_float):
    (_, jc), (_, tc) = integrate_both(pose(name), "eager", rgb_float=rgb_float)
    assert int((tc != fused()["tcol"]).sum()) > 5000
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("name,mode", [("rot", "eager"), ("rot", "jit"), ("novel", "jit"),
                                        ("shift", "jit"), ("identity", "jit")])
def test_integrate_dense_within_tolerance(name, mode):
    """Rotated poses and the jitted function: tsdf within TSDF_TOL (2 ulp
    of the camera depth over mu; measured 1.5e-6) and the weight equal,
    but for the voxels whose projection lies on a pixel border and rounds
    to the other pixel (at most 1e-4 of them; measured 15 of 262144 at the
    identity pose, where the voxel grid is aligned with the pixel grid)."""
    (jv, jc), (tv, tc) = integrate_both(pose(name), mode)
    w_off = tv.weight.numpy() != np.asarray(jv.weight)
    t_off = np.abs(tv.tsdf.numpy() - np.asarray(jv.tsdf)) > TSDF_TOL
    c_off = np.abs(tc.numpy() - np.asarray(jc)) > 1e-6
    assert w_off.mean() <= 1e-4 and t_off.mean() <= 1e-4 and c_off.mean() <= 1e-4
    assert not (t_off & ~w_off).any()


@pytest.mark.parametrize("stop_at_max", [False, True])
def test_integrate_dense_weight_rules(stop_at_max):
    """max_weight 2 makes the clamp and the stop-at-max gate bite on the
    4-frame volume (weights up to 4 are clamped first, as the rule would
    have)."""
    f = fused()
    cfg = make_cfg(max_weight=2.0, stop_integrating_at_max_weight=stop_at_max)
    tcfg = config_from_reference(cfg)
    T = pose("shift")
    d, _ = frame_at(T)
    jv = jd.DenseVolume(f["vol"].tsdf, jnp.minimum(f["vol"].weight, 2.0))
    tv = td.DenseVolume(f["tvol"].tsdf, f["tvol"].weight.clamp(max=2.0))
    with jax.disable_jit():
        want = jd.integrate_dense(jv, cfg.camera, cfg.tsdf, cfg.dense, jnp.asarray(T), d)
    got = td.integrate_dense(tv, tcfg.camera, tcfg.tsdf, tcfg.dense, t(T), t(d))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    np.testing.assert_array_equal(got.tsdf.numpy(), np.asarray(want.tsdf))
    assert float(got.weight.max()) == 2.0
    full = tv.weight >= 2.0
    changed = int((got.tsdf[full] != tv.tsdf[full]).sum())
    assert (changed == 0) if stop_at_max else (changed > 1000)


def test_integrate_leaves_its_inputs_untouched():
    f = fused()
    snap = (f["tvol"].tsdf.clone(), f["tvol"].weight.clone(), f["tcol"].clone())
    integrate_both(pose("rot"), "jit")
    assert all(torch.equal(a, b) for a, b in zip(snap, (*f["tvol"], f["tcol"])))


def test_all_invalid_depth_integrates_nothing():
    f = fused()
    tcfg = f["tcfg"]
    got = td.integrate_dense(f["tvol"], tcfg.camera, tcfg.tsdf, tcfg.dense,
                             torch.eye(4), torch.zeros((64, 80)))
    assert torch.equal(got.tsdf, f["tvol"].tsdf) and torch.equal(got.weight, f["tvol"].weight)


def test_make_volumes():
    cfg = fused()["tcfg"].dense
    v = td.make_dense_volume(cfg)
    assert v.tsdf.shape == v.weight.shape == (64, 64, 64)
    assert bool((v.tsdf == 1).all()) and not v.weight.any()
    assert td.make_color_volume(cfg, True).shape == (64, 64, 64, 3)
    dummy = td.make_color_volume(cfg, False)
    assert dummy.shape == (1, 1, 1, 3) and dummy.dtype == torch.float32 and not dummy.any()


# ----------------------------------------------------------------- reads
def queries(n=6000):
    """Fractional voxel coords inside the volume, across its faces, far
    outside and negative, from a seed."""
    rng = np.random.default_rng(4)
    pv = rng.uniform(-3, 67, size=(n, 3)).astype(np.float32)
    pv[::11] = rng.uniform(-500, 500, size=pv[::11].shape)
    pv[1::11] = np.round(pv[1::11])          # on voxel borders
    return pv


READS = {
    "nearest": lambda m, f, pv, k: m._sample_nearest(f[k + "vol"], pv, (64, 64, 64)),
    "trilinear": lambda m, f, pv, k: m._sample_trilinear(f[k + "vol"], pv, (64, 64, 64)),
    "color": lambda m, f, pv, k: (m.sample_color_dense(f[k + "col"], pv, (64, 64, 64)),),
    "normals": lambda m, f, pv, k: (m.sdf_normals(f[k + "vol"], pv, (64, 64, 64)),),
}


@pytest.mark.parametrize("read", list(READS))
def test_reads_match_jax(read):
    """Bit-equal to the eager JAX function (the normals within an ulp,
    1.2e-7: ``jnp.linalg.norm`` is a reduction, which XLA sums in an order
    of its own even alone); of the jitted one the integer outputs (nearest
    reads, the minimum weight) equal and the interpolated ones within 2 ulp
    of 1 (2.4e-7; the normals, a quotient of those by a gradient's norm
    that may be tiny, within 2e-5 on 99.9% of the samples)."""
    f = fused()
    pv = queries()
    fj = {"vol": f["vol"], "col": f["col"]}
    ft = {"tvol": f["tvol"], "tcol": f["tcol"]}
    got = READS[read](td, ft, t(pv), "t")
    with jax.disable_jit():
        eager = READS[read](jd, fj, jnp.asarray(pv), "")
    jitted = jax.jit(lambda pv: READS[read](jd, fj, pv, ""))(jnp.asarray(pv))
    inside = np.all((pv >= 0) & (pv < 64), axis=-1)
    assert 0.5 < inside.mean() < 0.95
    for g, e, j in zip(got, eager, jitted):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0,
                                   atol=1.2e-7 if read == "normals" else 0.0)
        atol = {"trilinear": 2.4e-7, "normals": 2e-5}.get(read, 0.0)
        off = np.abs(g.numpy() - np.asarray(j)) > atol
        assert off.mean() <= (1e-3 if read == "normals" else 0.0)
        assert g.dtype == torch.float32
    if read == "nearest":
        # Out of the volume reads free space.
        assert bool((got[0][~t(inside)] == 1).all()) and not got[1][~t(inside)].any()
        assert float(got[1].max()) == 4.0
    if read == "color":
        assert not got[0][~t(inside)].any() and float(got[0].max()) > 0.5


def test_trilinear_corner_order():
    """At a voxel centre the trilinear read is that voxel's value, and
    halfway to the next along z the mean of the two."""
    f = fused()
    v = f["tvol"]
    pv = torch.tensor([[20.5, 30.5, 25.5], [20.5, 30.5, 26.0]])
    s, w = td._sample_trilinear(v, pv, (64, 64, 64))
    assert float(s[0]) == float(v.tsdf[20, 30, 25])
    assert float(s[1]) == pytest.approx(0.5 * float(v.tsdf[20, 30, 25] + v.tsdf[20, 30, 26]), abs=1e-7)
    assert float(w[1]) == float(torch.minimum(v.weight[20, 30, 25], v.weight[20, 30, 26]))


# ----------------------------------------------------------------- raycast
def raycast_both(name, guided):
    f = fused()
    cfg, tcfg = f["cfg"], f["tcfg"]
    T = pose(name)
    kw, tkw = {}, {}
    if guided:
        d, _ = frame_at(T)
        margin = cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist
        kw = dict(expected_depth=d, depth_margin=margin, max_steps=cfg.raycast.guided_max_steps)
        tkw = dict(kw, expected_depth=t(d))
    jrc = jax.jit(lambda v, T: jd.raycast_dense(
        v, cfg.camera, cfg.tsdf, cfg.dense, cfg.raycast, T, **kw))(f["vol"], jnp.asarray(T))
    trc = td.raycast_dense(f["tvol"], tcfg.camera, tcfg.tsdf, tcfg.dense, tcfg.raycast,
                           t(T), **tkw)
    return jrc, trc


@pytest.mark.parametrize("guided", [False, True], ids=["full", "guided"])
@pytest.mark.parametrize("name", ["identity", "rot", "novel"])
def test_raycast_dense_matches_jax(name, guided):
    """``hit`` equal on every pixel; depth and points within 1e-5 m and the
    confidence equal on at least 99.5% of the pixels (measured: every pixel
    within 9e-7 m; the bound of the hashed-map raycast's test, for the same
    reason: a sample an ulp across a voxel border reads the neighbour);
    normals, finite differences of the points, within 1e-3 on 99.5%."""
    jrc, trc = raycast_both(name, guided)
    hit = trc.hit.numpy()
    assert hit.sum() > 1500
    np.testing.assert_array_equal(hit, np.asarray(jrc.hit))
    d_err = np.abs(trc.depth.numpy() - np.asarray(jrc.depth))
    p_err = np.abs(trc.points.numpy() - np.asarray(jrc.points)).max(-1)
    n_err = np.abs(trc.normals.numpy() - np.asarray(jrc.normals)).max(-1)
    assert (d_err <= 1e-5).mean() >= 0.995, d_err.max()
    assert (p_err <= 1e-5).mean() >= 0.995, p_err.max()
    assert (n_err <= 1e-3).mean() >= 0.995, n_err.max()
    assert (trc.confidence.numpy() == np.asarray(jrc.confidence)).mean() >= 0.995
    assert trc.depth.numpy()[~hit].max() == 0.0 and not trc.points.numpy()[~hit].any()
    for x in trc:
        assert x.dtype in (torch.float32, torch.bool) and x.shape[:2] == (64, 80)


def test_raycast_looking_away_hits_nothing():
    jrc, trc = raycast_both("away", False)
    assert not trc.hit.any() and not np.asarray(jrc.hit).any()
    assert torch.isfinite(trc.points).all() and not trc.normals.any() and not trc.depth.any()


def test_raycast_matches_exact_depth():
    """The port's full march against the scene's exact depth at the last
    fused pose (the bound of tests/test_pipeline_block.py: median error
    under 2 cm; the voxels here are 1.5 cm)."""
    f = fused()
    tcfg = f["tcfg"]
    from topfusion_tpu_torch.io.synthetic import SyntheticScene as TorchScene

    T = t(np.asarray(orbit_trajectory(4, 4.0, 0.04, seed=3)[3], np.float32))
    rc = td.raycast_dense(f["tvol"], tcfg.camera, tcfg.tsdf, tcfg.dense, tcfg.raycast, T)
    gt = TorchScene().render_depth(tcfg.camera, T).numpy()
    mask = rc.hit.numpy() & (gt > 0) & (gt < 1.5)
    assert mask.mean() > 0.25
    assert np.median(np.abs(rc.depth.numpy()[mask] - gt[mask])) < 0.02


def test_guided_band_is_a_subset_of_the_full_march():
    """Where the guided march hits, the full march hits at the same depth
    (within a voxel) on 99% of those pixels."""
    _, full = raycast_both("rot", False)
    _, guided = raycast_both("rot", True)
    both = guided.hit & full.hit
    assert int(guided.hit.sum()) > 1500 and float(both.sum() / guided.hit.sum()) > 0.99
    dd = torch.abs(guided.depth - full.depth)[both]
    assert float((dd < 0.015).float().mean()) > 0.99


def test_raycast_max_steps_and_inputs():
    """``max_steps`` overrides the config's, and the volume is not written."""
    f = fused()
    tcfg = f["tcfg"]
    snap = (f["tvol"].tsdf.clone(), f["tvol"].weight.clone())
    args = (f["tvol"], tcfg.camera, tcfg.tsdf, tcfg.dense, tcfg.raycast, t(pose("rot")))
    short = td.raycast_dense(*args, max_steps=3)
    same = td.raycast_dense(
        f["tvol"], tcfg.camera, tcfg.tsdf, tcfg.dense,
        dataclasses.replace(tcfg.raycast, max_steps=3), t(pose("rot")))
    assert int(short.hit.sum()) < 100 and torch.equal(short.hit, same.hit)
    assert torch.equal(short.depth, same.depth)
    assert all(torch.equal(a, b) for a, b in zip(snap, f["tvol"]))
