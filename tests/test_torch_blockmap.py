"""Port vs JAX package: the block map (pool codec, keys and hash,
deterministic allocation), allocation from depth and the visible sets.
All of these are integer results and must agree exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops import blockmap as jbm
from topfusion_tpu.ops import tsdf_block as jtb
from topfusion_tpu.ops.depth import depth_to_meters as j_depth_to_meters
from topfusion_tpu_torch.convert import block_state_from_numpy, config_from_reference
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import tsdf_block as ttb
from topfusion_tpu_torch.utils.numerics import linspace01

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tuples_equal(a, b, what):
    assert len(a) == len(b)
    names = getattr(a, "_fields", range(len(a)))
    for name, x, y in zip(names, a, b):
        np.testing.assert_array_equal(to_np(x), to_np(y), err_msg=f"{what}.{name}")


def jax_state_numpy(state):
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def seq():
    """The JAX pipeline after 3 frames of the test orbit, the 4th frame,
    its pose, and both configs."""
    cfg = make_cfg()
    cfg = dataclasses.replace(
        cfg, blockmap=dataclasses.replace(cfg.blockmap, visible_occlusion_cull=True))
    scene = SyntheticScene()
    poses = orbit_trajectory(4, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in poses]
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    for f in frames[:3]:
        state, _ = pipe.step(state, jnp.asarray(f))
    return cfg, config_from_reference(cfg), jax_state_numpy(state), frames[3], poses[3]


# ----------------------------------------------------------------- codec
def test_int16_codec_all_values():
    a = np.arange(-32768, 32768, dtype=np.int16)
    dj = np.asarray(jbm.decode_tsdf(jnp.asarray(a)))
    dt = tbm.decode_tsdf(t(a))
    np.testing.assert_array_equal(dt.numpy(), dj)
    back = tbm.encode_tsdf(dt, torch.int16).numpy()
    np.testing.assert_array_equal(back[1:], a[1:])  # -32768 clips to -32767
    np.testing.assert_array_equal(back, np.asarray(jbm.encode_tsdf(jnp.asarray(dj), jnp.int16)))
    w = np.arange(0, 200, dtype=np.int16)
    np.testing.assert_array_equal(
        tbm.encode_weight(tbm.decode_weight(t(w)), torch.int16).numpy(), w)


@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
def test_codec_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, size=4096).astype(np.float32)
    x[:4] = [0.5 / 32767, 1.5 / 32767, -0.5 / 32767, 2.5 / 32767]  # half-way cases
    jt = jbm.encode_tsdf(jnp.asarray(x), jnp.dtype(dtype))
    tt = tbm.encode_tsdf(t(x), tbm.pool_dtype(dtype))
    np.testing.assert_array_equal(tt.to(torch.float32).numpy(), np.asarray(jt, np.float32))
    np.testing.assert_array_equal(tbm.decode_tsdf(tt).numpy(), np.asarray(jbm.decode_tsdf(jt)))
    wx = rng.integers(0, 100, size=64).astype(np.float32) + 0.5
    np.testing.assert_array_equal(
        tbm.encode_weight(t(wx), tbm.pool_dtype(dtype)).to(torch.float32).numpy(),
        np.asarray(jbm.encode_weight(jnp.asarray(wx), jnp.dtype(dtype)), np.float32))


# ----------------------------------------------------------------- keys
@pytest.mark.parametrize("num_buckets", [1 << 12, 1 << 16, 1 << 20])
def test_keys_and_hash_negative_coords(num_buckets):
    bits = 10
    rng = np.random.default_rng(1)
    c = rng.integers(-512, 512, size=(5000, 3)).astype(np.int32)
    c[:8] = [[-512, -512, -512], [511, 511, 511], [-1, -1, -1], [0, 0, 0],
             [-512, 511, -1], [300, -300, 7], [-2, 5, -511], [511, -512, 0]]
    np.testing.assert_array_equal(
        tbm.spatial_hash(t(c), num_buckets).numpy(),
        np.asarray(jbm.spatial_hash(jnp.asarray(c), num_buckets)))
    k = tbm.pack_key(t(c), bits)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jbm.pack_key(jnp.asarray(c), bits)))
    np.testing.assert_array_equal(tbm.unpack_key(k, bits).numpy(), c)
    out = c.copy()
    out[::7] += 600
    np.testing.assert_array_equal(tbm.in_coord_range(t(out), bits).numpy(),
                                  np.asarray(jbm.in_coord_range(jnp.asarray(out), bits)))


# ----------------------------------------------------------------- allocate
@pytest.mark.parametrize("k", [1, 2, 4, 6, 7, 13])
def test_allocation_fractions_match_jnp_linspace(k):
    np.testing.assert_array_equal(
        linspace01(k, "cpu").numpy(),
        np.asarray(jnp.linspace(0.0, 1.0, k, dtype=jnp.float32)))


def _alloc_case(case):
    """(BlockMapConfig, list of candidate batches) for an allocate scenario."""
    base = dataclasses.replace(make_cfg().blockmap, capacity=1 << 10,
                               max_new_blocks_per_frame=256, max_visible_blocks=512)
    rng = np.random.default_rng(2)
    if case == "fresh_then_again":
        c = rng.integers(-6, 6, size=(400, 3))
        return base, [c, c]
    if case == "per_frame_bound":
        return dataclasses.replace(base, max_new_blocks_per_frame=16), \
            [rng.integers(-4, 4, size=(300, 3))] * 2
    if case == "bucket_overflow":
        # Twelve keys of one bucket (of 4 ways) among random ones.
        c = rng.integers(-40, 40, size=(20000, 3))
        b = np.asarray(jbm.spatial_hash(jnp.asarray(c, jnp.int32), base.capacity))
        same = c[b == np.bincount(b).argmax()][:12]
        return base, [np.concatenate([same, c[:100]]), np.concatenate([c[100:200], same])]
    if case == "pool_exhaustion":
        return dataclasses.replace(base, capacity=128, max_new_blocks_per_frame=128), \
            [rng.integers(-5, 5, size=(200, 3)) for _ in range(3)]
    if case == "out_of_range_and_invalid":
        c = rng.integers(-700, 700, size=(300, 3))
        return base, [c]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["fresh_then_again", "per_frame_bound", "bucket_overflow",
                                  "pool_exhaustion", "out_of_range_and_invalid"])
def test_allocate_matches_jax(case):
    cfg, batches = _alloc_case(case)
    mj = jbm.make_block_map(cfg, dtype=jnp.float32)
    mt = tbm.make_block_map(cfg, dtype=torch.float32)
    rng = np.random.default_rng(3)
    for c in batches:
        c = c.astype(np.int32)
        valid = rng.uniform(size=len(c)) > 0.1
        mj, ij = jbm.allocate(mj, jnp.asarray(c), jnp.asarray(valid), cfg, return_touched=True)
        mt, it = tbm.allocate(mt, t(c), t(valid), cfg, return_touched=True)
        assert_tuples_equal(it, ij, "AllocInfo")
        assert_tuples_equal(mt, mj, "BlockMap")
    mj2, nj = jbm.allocate(mj, jnp.asarray(c), jnp.asarray(valid), cfg)
    mt2, nt = tbm.allocate(mt, t(c), t(valid), cfg)
    assert int(nt) == int(nj)
    if case == "bucket_overflow":
        assert int(ij.n_dropped_deferred) > 0
    if case == "pool_exhaustion":
        assert int(ij.n_dropped_capacity) > 0


def test_lookup_and_reset(seq):
    _, tcfg_, sj, _, _ = seq
    st = block_state_from_numpy(sj, device="cpu")
    m = st.block_map()
    mj = jbm.BlockMap(*[jnp.asarray(sj[f]) for f in jbm.BlockMap._fields])
    coords = np.concatenate([sj["block_coords"][:50],
                             np.random.default_rng(4).integers(-40, 40, size=(50, 3))]).astype(np.int32)
    sj_, fj = jbm.lookup(mj, jnp.asarray(coords), tcfg_.blockmap.coord_bits)
    st_, ft = tbm.lookup(m, t(coords), tcfg_.blockmap.coord_bits)
    np.testing.assert_array_equal(st_.numpy(), np.asarray(sj_))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft[:50].all()
    assert_tuples_equal(tbm.reset_block_map(m), jbm.reset_block_map(mj), "reset")
    assert_tuples_equal(tbm.select_block_map(torch.tensor(True), m), jbm.reset_block_map(mj),
                        "select(True)")
    assert_tuples_equal(tbm.select_block_map(torch.tensor(False), m), mj, "select(False)")


@pytest.mark.parametrize("use_color", [False, True])
@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
def test_make_reset_select_with_color_pool(dtype, use_color):
    """``make_block_map`` builds the JAX package's arrays (a
    [C+1,B,B,B,3] color pool of the pool dtype with ``use_color``, else
    the [1,1,1,1,3] dummy), and reset / select return a painted pool to
    them."""
    cfg = dataclasses.replace(make_cfg().blockmap, capacity=64, pool_dtype=dtype)
    tcfg = config_from_reference(dataclasses.replace(make_cfg(), blockmap=cfg)).blockmap
    mj = jbm.make_block_map(cfg, use_color=use_color)
    mt = tbm.make_block_map(tcfg, use_color=use_color, device="cpu")
    assert mt.color.shape == ((65, 8, 8, 8, 3) if use_color else (1, 1, 1, 1, 3))
    assert mt.color.dtype == mt.tsdf.dtype == tbm.pool_dtype(dtype)

    def widen(m):
        return [np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)
                for a in m]

    def host(m):
        return [a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy() for a in m]

    for a, b in zip(host(mt), widen(mj)):
        np.testing.assert_array_equal(a, b)
    painted = mt._replace(color=torch.ones_like(mt.color), weight=torch.ones_like(mt.weight),
                          num_blocks=torch.tensor(3, dtype=torch.int32))
    for out in (tbm.reset_block_map(painted), tbm.select_block_map(torch.tensor(True), painted)):
        for a, b in zip(host(out), widen(mj)):
            np.testing.assert_array_equal(a, b)
    kept = tbm.select_block_map(torch.tensor(False), painted)
    assert all(torch.equal(a, b) for a, b in zip(kept, painted))
    assert kept.color is not painted.color        # a new tensor: the step writes into it


def test_allocate_from_depth_matches_jax(seq):
    jc, tc, sj, f3, T3 = seq
    mj = jbm.BlockMap(*[jnp.asarray(sj[f]) for f in jbm.BlockMap._fields])
    mt = block_state_from_numpy(sj, device="cpu").block_map()
    raw = np.asarray(j_depth_to_meters(jnp.asarray(f3)))
    T = np.asarray(T3, np.float32)
    for m_j, m_t in ((mj, mt), (jbm.reset_block_map(mj), tbm.reset_block_map(mt))):
        oj, ij = jtb.allocate_from_depth(m_j, jc.camera, jc.tsdf, jc.blockmap,
                                         jnp.asarray(T), jnp.asarray(raw), return_touched=True)
        ot, it = ttb.allocate_from_depth(m_t, tc.camera, tc.tsdf, tc.blockmap,
                                         t(T), t(raw), return_touched=True)
        assert int(it.n_inserted) > 0 or int(m_t.num_blocks) > 0
        assert_tuples_equal(it, ij, "AllocInfo")
        assert_tuples_equal(ot, oj, "BlockMap")


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("v_max", [None, 256])
def test_visible_sets_match_jax(seq, cull, v_max):
    """Full scan and aged set, with the overflow count; v_max=256 forces
    truncation."""
    jc, tc, sj, f3, T3 = seq
    if v_max is not None:
        jc = dataclasses.replace(jc, blockmap=dataclasses.replace(jc.blockmap, max_visible_blocks=v_max))
        tc = config_from_reference(jc)
    mj = jbm.BlockMap(*[jnp.asarray(sj[f]) for f in jbm.BlockMap._fields])
    mt = block_state_from_numpy(sj, device="cpu").block_map()
    raw = np.asarray(j_depth_to_meters(jnp.asarray(f3)))
    T = np.asarray(T3, np.float32)
    dj = jnp.asarray(raw) if cull else None
    dt = t(raw) if cull else None
    vj = jtb.visible_blocks(mj, jc.camera, jc.tsdf, jc.blockmap, jnp.asarray(T),
                            return_overflow=True, depth=dj)
    vt = ttb.visible_blocks(mt, tc.camera, tc.tsdf, tc.blockmap, t(T),
                            return_overflow=True, depth=dt)
    assert_tuples_equal(vt, vj, "visible_blocks")
    assert int(vt[2].sum()) > 50
    if v_max is not None:
        assert int(vt[3]) > 0

    prev = sj["vis_slots"][: jc.blockmap.max_visible_blocks]
    rng = np.random.default_rng(5)
    touched = np.full(jc.blockmap.max_visible_blocks, -1, np.int32)
    touched[:40] = rng.integers(0, int(sj["num_blocks"]), size=40)
    ij = jtb.visible_blocks_incremental(mj, jc.camera, jc.tsdf, jc.blockmap, jnp.asarray(T),
                                        jnp.asarray(prev), jnp.asarray(touched),
                                        return_overflow=True, depth=dj)
    it = ttb.visible_blocks_incremental(mt, tc.camera, tc.tsdf, tc.blockmap, t(T),
                                        t(prev), t(touched), return_overflow=True, depth=dt)
    assert_tuples_equal(it, ij, "visible_blocks_incremental")
