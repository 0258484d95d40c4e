"""RGB fusion of the port against the JAX package: the color pass alone
(``integrate_color_blocks``), the synthetic scene's color frames, and
``step_rgb`` end to end over the 8-frame test orbit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline_block import rot_deg
from tests.test_torch_raycast import color_cfg, fused
from topfusion_tpu.io.synthetic import SyntheticScene as JaxScene
from topfusion_tpu.ops import blockmap as jbm
from topfusion_tpu.ops import tsdf_block as jtb
from topfusion_tpu_torch.convert import (
    block_state_from_numpy,
    block_state_to_numpy,
    config_from_reference,
)
from topfusion_tpu_torch.io.synthetic import SyntheticScene
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import tsdf_block as ttb

torch.set_num_threads(2)


def ulp_distance(a, b):
    """Distance in float32 steps (both arrays finite and of one sign)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# ----------------------------------------------------------------- the color pass
@pytest.mark.parametrize("rgb_kind", ["uint8", "float32"])
@pytest.mark.parametrize("pool", ["int16", "float32", "bfloat16"])
def test_integrate_color_blocks_matches_jax(pool, rgb_kind):
    """One more color frame fused into the 8-frame map, the pool recast to
    each storage dtype.  Against the JAX function run op by op the pool is
    bit-equal in every dtype.  Under jit XLA contracts ``c * w + c_obs``
    into a fused multiply-add where the port rounds twice: float32 pools
    are then within 2 ulp, and int16 / bfloat16 pools equal but for values
    that the ulp moves across a rounding border (under 0.1% of the updated
    values, by one storage step)."""
    f = fused()
    cfg, tcfg = f["cfg"], f["tcfg"]
    T = f["j_poses"][-1]
    depth = f["depths"][-1].astype(np.float32) / np.float32(1000.0)
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, size=(64, 80, 3)).astype(np.uint8)
    if rgb_kind == "float32":
        rgb = rng.uniform(0, 1, size=(64, 80, 3)).astype(np.float32)

    jdt = jnp.dtype(pool)
    jm = f["jm"]
    jm = jm._replace(color=jbm.encode_tsdf(jbm.decode_tsdf(jm.color), jdt),
                     weight=jbm.encode_weight(jbm.decode_weight(jm.weight), jdt))
    arrays = {k: np.asarray(v) for k, v in jm._asdict().items()}
    tm = block_state_from_numpy(
        {**{k: np.asarray(v) if not isinstance(v, tuple) else v
            for k, v in f["js"]._asdict().items()}, **arrays}, device="cpu").block_map()
    assert tm.color.dtype == tbm.pool_dtype(pool)
    before = tm.color.clone()

    jv = jtb.visible_blocks(jm, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.asarray(T))
    tv = ttb.visible_blocks(tm, tcfg.camera, tcfg.tsdf, tcfg.blockmap, torch.from_numpy(T.copy()))
    def jax_color(m, T, d, c, v):
        return jtb.integrate_color_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T, d, c, v).color

    jargs = (jm, jnp.asarray(T), jnp.asarray(depth), jnp.asarray(rgb), jv)
    eager, jitted = jax_color(*jargs), jax.jit(jax_color)(*jargs)
    tout = ttb.integrate_color_blocks(
        tm, tcfg.camera, tcfg.tsdf, tcfg.blockmap, torch.from_numpy(T.copy()),
        torch.from_numpy(depth), torch.from_numpy(rgb), tv)
    assert tout.color is tm.color                       # in place
    changed = int((tout.color != before).sum())
    assert changed > 5000
    def host(c):
        return np.asarray(c.astype(jnp.float32)) if pool == "bfloat16" else np.asarray(c)

    got = block_state_to_numpy(f["ts"]._replace(color=tout.color))["color"]
    assert got.shape == (cfg.blockmap.capacity + 1, 8, 8, 8, 3)
    np.testing.assert_array_equal(got, host(eager))
    want = host(jitted)
    if pool == "float32":
        assert ulp_distance(got, want).max() <= 2
    else:
        assert (got != want).sum() <= 0.001 * changed
        step = 1 if pool == "int16" else np.abs(want) * 2.0 ** -7
        assert np.all(np.abs(got.astype(np.float32) - want.astype(np.float32)) <= step)
    for name in ("tsdf", "weight", "bucket_keys", "block_coords"):
        assert torch.equal(getattr(tout, name), getattr(tm, name))


def test_color_takes_only_the_surface_band():
    """Voxels farther than mu/4 from the observed surface keep their
    color: an all-white frame changes fewer voxels than the depth pass
    updated, and every changed voxel has weight."""
    f = fused()
    tcfg = f["tcfg"]
    m = f["ts"].block_map()
    m = m._replace(color=torch.zeros_like(m.color))
    T = torch.from_numpy(f["j_poses"][-1].copy())
    depth = torch.from_numpy(f["depths"][-1].astype(np.float32) / np.float32(1000.0))
    vis = ttb.visible_blocks(m, tcfg.camera, tcfg.tsdf, tcfg.blockmap, T)
    out = ttb.integrate_color_blocks(m, tcfg.camera, tcfg.tsdf, tcfg.blockmap, T, depth,
                                     torch.full((64, 80, 3), 255, dtype=torch.uint8), vis)
    colored = (out.color[:-1] != 0).any(-1)
    assert 1000 < int(colored.sum()) < int((m.weight[:-1] > 0).sum()) // 2
    assert bool((m.weight[:-1][colored] > 0).all())


# ----------------------------------------------------------------- frames
def test_synthetic_color_matches_jax():
    """``primitive_colors`` equal; ``color_at`` equal on random points but
    for those within float rounding of two primitives' border; the RGB
    frame equal on 99% of the pixels (its depth march differs in the last
    bits, so a pixel on a primitive's silhouette may flip)."""
    cfg, tcfg = color_cfg(), config_from_reference(color_cfg())
    js, ts = JaxScene(), SyntheticScene()
    np.testing.assert_array_equal(ts.primitive_colors().numpy(), np.asarray(js.primitive_colors()))
    p = np.random.default_rng(3).uniform(-1, 2, size=(5000, 3)).astype(np.float32)
    same = (ts.color_at(torch.from_numpy(p)).numpy() == np.asarray(js.color_at(jnp.asarray(p)))).all(-1)
    assert same.mean() > 0.999
    T = fused()["gt"][3].astype(np.float32)
    want = np.asarray(js.render_rgb(cfg.camera, jnp.asarray(T)))
    got = ts.render_rgb(tcfg.camera, torch.from_numpy(T.copy()))
    assert got.dtype == torch.uint8 and got.shape == (64, 80, 3)
    assert (got.numpy() == want).all(-1).mean() > 0.99
    assert len(np.unique(got.numpy().reshape(-1, 3), axis=0)) >= 5   # 4 primitives + black


# ----------------------------------------------------------------- step_rgb
@pytest.fixture(scope="module")
def rgb_run():
    f = fused()
    pipe, state = f["tp"], f["tp"].init()
    poses, auxes = [], []
    for d, c in zip(f["depths"], f["rgbs"]):
        state, aux = pipe.step_rgb(state, torch.from_numpy(d), torch.from_numpy(c))
        poses.append(state.T_wc.numpy().copy())
        auxes.append(aux)
    return state, poses, auxes


@pytest.mark.parametrize("frame", range(8))
def test_step_rgb_follows_jax_per_frame(rgb_run, frame):
    """Within the 0.07 mm the depth-only step holds (0.25 mm / 0.01
    degrees allowed, as in tests/test_torch_pipeline_block.py)."""
    f = fused()
    _, poses, auxes = rgb_run
    Tj, Tt = f["j_poses"][frame], poses[frame]
    assert bool(auxes[frame].ok)
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 2.5e-4
    assert rot_deg(Tt[:3, :3], Tj[:3, :3]) <= 0.01


def test_step_rgb_map_matches_jax(rgb_run):
    """Same blocks in the same slots; the color pool (int16) equal on 98%
    of its values and within 0.02 on 99.9% (the poses differ by hundredths
    of a millimetre, which moves some voxels across the band's edge or a
    pixel border)."""
    f = fused()
    state, poses, _ = rgb_run
    js = f["js"]
    assert int(state.num_blocks) == int(js.num_blocks)
    np.testing.assert_array_equal(state.block_coords.numpy(), np.asarray(js.block_coords))
    assert state.color.shape == (f["cfg"].blockmap.capacity + 1, 8, 8, 8, 3)
    got = tbm.decode_tsdf(state.color).numpy()
    want = np.asarray(jbm.decode_tsdf(js.color))
    assert float(np.abs(got).max()) > 0.5               # color was fused
    assert (got == want).mean() > 0.98
    assert np.percentile(np.abs(got - want), 99.9) <= 0.02
    assert ate_rmse(poses, f["gt"], align=False) < 0.012


def test_color_does_not_touch_geometry(rgb_run):
    """The same frames through ``step`` (no rgb): poses and TSDF pool bit
    for bit those of ``step_rgb``, and the color pool stays zero."""
    f = fused()
    rgb_state, poses, _ = rgb_run
    pipe, state = f["tp"], f["tp"].init()
    for i, d in enumerate(f["depths"]):
        state, _ = pipe.step(state, torch.from_numpy(d))
        assert np.array_equal(state.T_wc.numpy(), poses[i])
    assert torch.equal(state.tsdf, rgb_state.tsdf) and torch.equal(state.weight, rgb_state.weight)
    assert not state.color.any()


def test_block_color_fusion_and_render():
    """tests/test_color.py's hashed-map case on the port: a red-over-green
    frame fused three times renders red above and green below."""
    cfg = config_from_reference(color_cfg())
    pipe = BlockPipeline(cfg, device="cpu")
    state = pipe.init()
    assert state.color.shape[0] == cfg.blockmap.capacity + 1
    depth = SyntheticScene().render_depth_mm(cfg.camera, torch.eye(4))
    h, w = cfg.camera.height, cfg.camera.width
    rgb = torch.zeros((h, w, 3), dtype=torch.uint8)
    rgb[: h // 2, :, 0] = 220
    rgb[h // 2:, :, 1] = 220
    for _ in range(3):
        state, aux = pipe.step_rgb(state, depth, rgb)
        assert bool(aux.ok)
    assert float(tbm.decode_tsdf(state.color).abs().max()) > 0.5
    img = pipe.render_color(state).numpy()
    assert img.shape == (h, w, 3) and img.dtype == np.uint8
    lit = img.sum(axis=-1) > 30
    top, bot = img[: h // 2][lit[: h // 2]], img[h // 2:][lit[h // 2:]]
    assert len(top) > 50 and len(bot) > 50
    assert top[:, 0].mean() > top[:, 1].mean() + 30
    assert bot[:, 1].mean() > bot[:, 0].mean() + 30


def test_block_color_disabled_dummy():
    """Without ``use_color`` the pool is the [1,1,1,1,3] dummy, ``step_rgb``
    fuses geometry only and ``render_color`` is black."""
    cfg = color_cfg()
    cfg = config_from_reference(dataclasses.replace(
        cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=False)))
    pipe = BlockPipeline(cfg, device="cpu")
    state = pipe.init()
    assert state.color.shape == (1, 1, 1, 1, 3)
    f = fused()
    state, aux = pipe.step_rgb(state, torch.from_numpy(f["depths"][0]), torch.from_numpy(f["rgbs"][0]))
    assert bool(aux.ok) and state.color.shape == (1, 1, 1, 1, 3) and not state.color.any()
    assert not pipe.render_color(state).any()


@pytest.mark.parametrize("pool", ["int16", "float32", "bfloat16"])
def test_state_with_color_round_trips(pool):
    """``convert`` carries the color pool across in every pool dtype."""
    f = fused()
    arrays = {k: (np.asarray(v) if not isinstance(v, tuple) else tuple(np.asarray(x) for x in v))
              for k, v in f["js"]._asdict().items()}
    jdt = jnp.dtype(pool)
    arrays["color"] = np.asarray(jbm.encode_tsdf(jbm.decode_tsdf(f["js"].color), jdt))
    st = block_state_from_numpy(arrays, device="cpu")
    assert st.color.dtype == tbm.pool_dtype(pool) and st.color.shape == arrays["color"].shape
    back = block_state_to_numpy(st)["color"]
    want = arrays["color"].astype(np.float32) if pool == "bfloat16" else arrays["color"]
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(tbm.decode_tsdf(st.color).numpy(),
                                  np.asarray(jbm.decode_tsdf(jnp.asarray(arrays["color"]))))
