"""Out-of-core block swap of the port against the JAX package: the three
device primitives of ``ops/swap.py`` field by field in three pool dtypes,
the host cache's frustum test and store remap, and a corridor sweep
beyond pool capacity through ``BlockPipeline`` + ``HostBlockCache``.

How the sweep is compared.  The corridor at the 80x64 test size is badly
conditioned for ICP: a difference of 1e-6 m in the model maps moves the
next pose by up to 0.6 mm (measured by stepping one carried state twice),
so two free-running sweeps drift apart by millimetres within a few frames
whatever the port does.  The JAX sweep is therefore the master: before
every frame its state and its cache are carried into the port, the port
runs restore -> step -> evict on that frame, and the results of that one
frame are compared.  A second, free-running sweep of the port alone is
held to the JAX package's own acceptance test (tests/test_swap.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from topfusion_tpu.config import tiny_test_config
from topfusion_tpu.geometry.se3 import se3_exp
from topfusion_tpu.io.synthetic import corridor_scene, sweep_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.models.host_cache import HostBlockCache as JaxCache
from topfusion_tpu.models.host_cache import host_visible_mask as j_visible_mask
from topfusion_tpu.ops import blockmap as jbm
from topfusion_tpu.ops import swap as jsw
from topfusion_tpu_torch.convert import (
    _to_tensor,
    block_state_from_numpy,
    config_from_reference,
)
from topfusion_tpu_torch.io.trajectory import ate_rmse
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.models.host_cache import HostBlockCache, host_visible_mask
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import swap as tsw

torch.set_num_threads(2)

DTYPES = ["float32", "int16", "bfloat16"]


def bits(a) -> np.ndarray:
    """An array or tensor as numpy, bfloat16 as its int16 bit pattern."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def assert_fields_equal(got, want, what):
    for name, g, w in zip(type(want)._fields, got, want):
        g, w = bits(g), bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


def port_map(m) -> tbm.BlockMap:
    return tbm.BlockMap(*[_to_tensor(np.asarray(x), "cpu") for x in m])


def assert_restored(m, slots, tsdf, weight, color):
    """Rows ``slots`` of map ``m`` hold the payload (tsdf, weight, color)
    as a merge into empty rows leaves it: the weight as it was; tsdf and
    color ``(0 * 0 + x * w) / w``, which is x to the bit in the int16 and
    bfloat16 codecs and within an ulp (1e-6) in float32; a voxel of weight
    0 reads free space (tsdf 1) and black."""
    rows = slots.long()
    np.testing.assert_array_equal(bits(m.weight[rows]), bits(weight))
    seen = (weight.to(torch.float32) > 0).numpy()
    atol = 1e-6 if m.tsdf.dtype == torch.float32 else 0.0
    for pool, payload, empty in ((m.tsdf, tsdf, 1.0), (m.color, color, 0.0)):
        got = tbm.decode_tsdf(pool[rows]).numpy()
        want = tbm.decode_tsdf(payload).numpy()
        mask = seen if got.ndim == 4 else np.broadcast_to(seen[..., None], got.shape)
        np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=atol)
        assert np.all(got[~mask] == empty)


# ----------------------------------------------------------------- primitives
@functools.lru_cache(maxsize=None)
def filled_map(dtype: str, use_color: bool):
    """(JAX cfg, port cfg, JAX map, live blocks): 512 slots almost full of
    random blocks with random payloads in every row, the sacrificial one
    included."""
    base = tiny_test_config()
    cfg = dataclasses.replace(
        base.blockmap, pool_dtype=dtype, capacity=512, max_new_blocks_per_frame=128
    )
    tcfg = config_from_reference(dataclasses.replace(base, blockmap=cfg)).blockmap
    rng = np.random.default_rng(0)
    m = jbm.make_block_map(cfg, use_color=use_color)
    for _ in range(4):
        coords = jnp.asarray(rng.integers(-6, 6, size=(200, 3)), jnp.int32)
        m, _ = jbm.allocate(m, coords, jnp.ones(200, bool), cfg)
    jd = jnp.dtype(dtype)
    m = m._replace(
        tsdf=jbm.encode_tsdf(jnp.asarray(rng.uniform(-1, 1, m.tsdf.shape), jnp.float32), jd),
        weight=jbm.encode_weight(jnp.asarray(rng.integers(0, 20, m.weight.shape), jnp.float32), jd),
    )
    if use_color:
        m = m._replace(color=jbm.encode_tsdf(
            jnp.asarray(rng.uniform(0, 1, m.color.shape), jnp.float32), jd))
    nb = int(m.num_blocks)
    assert 400 < nb < 512
    return cfg, tcfg, m, nb


def slot_list(kind: str, nb: int) -> np.ndarray:
    rng = np.random.default_rng(1)
    if kind == "some":
        # 60 live slots, -1 padding, and three that are not live.
        s = np.r_[rng.permutation(nb)[:60], -np.ones(4), [nb, nb + 3, 511]]
    elif kind == "empty":
        s = -np.ones(16)
    else:
        s = np.arange(nb)
    return s.astype(np.int32)


@pytest.mark.parametrize("kind", ["some", "empty", "all"])
@pytest.mark.parametrize("use_color", [False, True], ids=["nocolor", "color"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_swap_primitives_equal_jax(dtype, use_color, kind):
    """extract -> evict -> insert (into the freed rows) -> insert again
    (now a merge with the blocks just restored): every field of every
    result EQUAL to the JAX package's, jitted as its cache runs them:
    bucket tables, coords, the pools to the bit with the sacrificial row,
    the remap and the restored mask."""
    cfg, tcfg, m, nb = filled_map(dtype, use_color)
    tm = port_map(m)
    snap = [x.clone() for x in tm]
    slots = slot_list(kind, nb)
    ex = jsw.extract_blocks(m, jnp.asarray(slots))
    tex = tsw.extract_blocks(tm, torch.from_numpy(slots))
    assert_fields_equal(tex, ex, "extract")
    assert int(tex.valid.sum()) == {"some": 60, "empty": 0, "all": nb}[kind]

    m2, remap = jax.jit(lambda m, s: jsw.evict_blocks(m, s, cfg))(m, jnp.asarray(slots))
    tm2, tremap = tsw.evict_blocks(tm, torch.from_numpy(slots), tcfg)
    assert_fields_equal(tm2, m2, "evict")
    np.testing.assert_array_equal(tremap.numpy(), np.asarray(remap))
    assert tremap.dtype == torch.int32 and tm2.num_blocks.dtype == torch.int32
    assert int(tm2.num_blocks) == nb - int(tex.valid.sum())

    # A restore batch is bounded by max_new_blocks_per_frame.
    k = cfg.max_new_blocks_per_frame
    exk = jsw.ExtractedBlocks(*[x[:k] for x in ex])
    texk = tsw.ExtractedBlocks(*[x[:k] for x in tex])
    m3, ok = jax.jit(lambda m, b: jsw.insert_blocks(m, b, cfg, 100.0))(m2, exk)
    tm3, tok = tsw.insert_blocks(tm2, texk, tcfg, 100.0)
    assert_fields_equal(tm3, m3, "insert")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))

    m4, ok4 = jax.jit(lambda m, b: jsw.insert_blocks(m, b, cfg, 30.0))(m3, exk)
    tm4, tok4 = tsw.insert_blocks(tm3, texk, tcfg, 30.0)
    assert_fields_equal(tm4, m4, "merge")
    np.testing.assert_array_equal(tok4.numpy(), np.asarray(ok4))
    if kind != "empty":
        assert bool(tok4.any()) and not torch.equal(tm4.weight, tm3.weight)
    # Nothing was written into a map that was passed in.
    assert all(torch.equal(a, b) for a, b in zip(snap, tm))


@pytest.mark.parametrize("dtype", DTYPES)
def test_evict_then_restore_is_bit_exact(dtype):
    """Evicted payloads return (see ``assert_restored``), and every kept
    block stays findable at its remapped slot: the form of tests/test_swap.py::test_evict_restore_round_trip."""
    cfg, tcfg, m, nb = filled_map(dtype, True)
    tm = port_map(m)
    slots = torch.from_numpy(slot_list("some", nb))
    ex = tsw.extract_blocks(tm, slots)
    tm2, remap = tsw.evict_blocks(tm, slots, tcfg)
    kept = torch.nonzero(remap >= 0).flatten()
    slot2, found2 = tbm.lookup(tm2, tm.block_coords[kept], tcfg.coord_bits)
    assert bool(found2.all()) and torch.equal(slot2, remap[kept])
    assert torch.equal(tm2.tsdf[remap[kept].long()], tm.tsdf[kept])
    _, found_gone = tbm.lookup(tm2, ex.coords[ex.valid], tcfg.coord_bits)
    assert not bool(found_gone.any())

    tm3, ok = tsw.insert_blocks(tm2, ex, tcfg, max_weight=100.0)
    assert torch.equal(ok, ex.valid)
    slot3, found3 = tbm.lookup(tm3, ex.coords[ex.valid], tcfg.coord_bits)
    assert bool(found3.all())
    v = ex.valid
    assert_restored(tm3, slot3, ex.tsdf[v], ex.weight[v], ex.color[v])


def test_insert_merges_when_reallocated():
    """tests/test_swap.py's merge case: a block re-observed while swapped
    out is fused with its host copy by weight, not overwritten."""
    cfg = config_from_reference(tiny_test_config()).blockmap
    m = tbm.make_block_map(cfg, device="cpu")
    c = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    m, _ = tbm.allocate(m, c, torch.ones(1, dtype=torch.bool), cfg)
    m.tsdf[0] = 0.2
    m.weight[0] = 10.0
    b = cfg.block_size
    host = tsw.ExtractedBlocks(
        coords=c,
        tsdf=torch.full((1, b, b, b), 0.8),
        weight=torch.full((1, b, b, b), 30.0),
        color=torch.zeros((1, 1, 1, 1, 3)),
        valid=torch.ones(1, dtype=torch.bool),
    )
    m2, ok = tsw.insert_blocks(m, host, cfg, max_weight=100.0)
    assert bool(ok[0])
    np.testing.assert_allclose(m2.tsdf[0].numpy(), (0.2 * 10.0 + 0.8 * 30.0) / 40.0, atol=1e-6)
    np.testing.assert_allclose(m2.weight[0].numpy(), 40.0, atol=1e-6)


def test_insert_beyond_the_allocation_bound_keeps_the_rest_out():
    """A batch larger than max_new_blocks_per_frame restores only what the
    allocator admits; the mask says which, as in the JAX package."""
    cfg, tcfg, m, nb = filled_map("int16", False)
    slots = slot_list("all", nb)
    ex = jsw.extract_blocks(m, jnp.asarray(slots))
    m2, _ = jsw.evict_blocks(m, jnp.asarray(slots), cfg)
    m3, ok = jsw.insert_blocks(m2, ex, cfg, 100.0)
    tex = tsw.ExtractedBlocks(*[_to_tensor(np.asarray(x), "cpu") for x in ex])
    tm3, tok = tsw.insert_blocks(port_map(m2), tex, tcfg, 100.0)
    assert int(tok.sum()) == cfg.max_new_blocks_per_frame < nb
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    assert_fields_equal(tm3, m3, "insert")


# ----------------------------------------------------------------- host cache
def sweep_cfg(capacity):
    base = tiny_test_config()
    return dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
        blockmap=dataclasses.replace(
            base.blockmap, capacity=capacity, max_visible_blocks=min(capacity, 1 << 11)),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_visible_mask_equals_jax(seed):
    base = sweep_cfg(1 << 11)
    tb = config_from_reference(base)
    rng = np.random.default_rng(seed)
    coords = rng.integers(-40, 40, size=(5000, 3)).astype(np.int32)
    T = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.4, 6), jnp.float32)))
    want = j_visible_mask(coords, T, base.blockmap, base.tsdf, base.camera)
    got = host_visible_mask(coords, T, tb.blockmap, tb.tsdf, tb.camera)
    assert 0.005 < got.mean() < 0.5
    np.testing.assert_array_equal(got, want)


def _payloads(dtype, color):
    """Two stored blocks (tsdf 0.2 / weight 10 and 0.8 / 30, encoded for
    ``dtype``), as numpy arrays for the JAX cache and CPU tensors for the
    port's."""
    b = 8
    scale = 32767.0 if dtype == "int16" else 1.0
    npdt = {"float32": np.float32, "int16": np.int16, "bfloat16": ml_dtypes.bfloat16}[dtype]
    out = []
    for t, w, c in ((0.2, 10, 0.5), (0.8, 30, 0.25)):
        arrs = (np.full((b, b, b), t * scale).astype(npdt), np.full((b, b, b), w).astype(npdt),
                np.full((b, b, b, 3), c * scale).astype(npdt) if color else None)
        out.append((arrs, tuple(None if a is None else _to_tensor(a, "cpu") for a in arrs)))
    return out


def _caches():
    base = tiny_test_config()
    tb = config_from_reference(base)
    return (JaxCache(base.blockmap, base.tsdf, base.camera),
            HostBlockCache(tb.blockmap, tb.tsdf, tb.camera, device="cpu"),
            base.blockmap.block_size * base.tsdf.voxel_size)


def assert_stores_equal(got: dict, want: dict):
    assert list(got.keys()) == list(want.keys())
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert (g is None) == (w is None)
            if w is not None:
                g, w = bits(g), bits(w)
                assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
                np.testing.assert_array_equal(g, w)


def test_remap_store_rekeys_by_a_whole_block():
    """tests/test_swap.py's first case: a one-block translation shifts the
    keys and leaves the payloads alone."""
    jc, tc, bm = _caches()
    (a, ta), (b, tb_) = _payloads("float32", False)
    for cache, p1, p2 in ((jc, a, b), (tc, ta, tb_)):
        cache.store = {(0, 0, 5): p1, (1, 0, 5): p2, (4, 4, 9): p1}
    corr = np.eye(4)
    corr[0, 3] = bm
    jc.remap_store(corr)
    tc.remap_store(corr)
    assert set(tc.store) == {(1, 0, 5), (2, 0, 5), (5, 4, 9)}
    assert_stores_equal(tc.store, jc.store)
    assert torch.equal(tc.store[(2, 0, 5)][0], tb_[0])


@pytest.mark.parametrize("color", [False, True], ids=["nocolor", "color"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_remap_store_merges_collisions_as_jax(dtype, color):
    """tests/test_swap.py's second case, in every pool dtype: two blocks
    that land on one key merge by weight, on the STORED values.  float32:
    the weighted mean.  bfloat16: the same, rounded per operation, the
    result widened to float32.  int16: the stored tsdf is scaled by 32767,
    so ``t * w`` wraps around in int16 and the merged entry is wrong, in
    float64; the port reproduces the JAX package here, it does not repair
    it (ROADMAP.md section 3)."""
    jc, tc, bm = _caches()
    (a, ta), (b, tb_) = _payloads(dtype, color)
    jc.store = {(0, 0, 5): a, (1, 0, 5): b}
    tc.store = {(0, 0, 5): ta, (1, 0, 5): tb_}
    corr = np.eye(4)
    corr[0, 3] = -0.5 * bm  # both centres round into block x = 0
    jc.remap_store(corr)
    tc.remap_store(corr)
    assert set(tc.store) == {(0, 0, 5)}
    assert_stores_equal(tc.store, jc.store)
    t, w, _ = tc.store[(0, 0, 5)]
    assert float(w.flatten()[0]) == 40.0
    if dtype == "int16":
        assert t.dtype == torch.float64 and float(t.flatten()[0]) < 0   # the wrapped product
    else:
        np.testing.assert_allclose(t.numpy(), (0.2 * 10 + 0.8 * 30) / 40.0, atol=4e-3)
        assert t.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_round_trip(dtype):
    """Pressure evicts through the cache (payloads kept in the pool dtype
    on the host, to the bit), a pose that sees everything restores: every
    block is back with its payload, kept or restored (``assert_restored``:
    the host adds nothing to what the merge itself does)."""
    cfg, tcfg, m, nb = filled_map(dtype, True)
    tb = config_from_reference(tiny_test_config())
    tm = port_map(m)
    cache = HostBlockCache(tcfg, tb.tsdf, tb.camera, evict_batch=64, restore_batch=128,
                           headroom=200, device="cpu")
    vis = np.arange(nb - 100, nb, dtype=np.int32)     # the last 100 slots were just seen
    tm2, remap = cache.after_step(tm, vis)
    n_out = cache.n_host_blocks
    assert n_out == 200 - (512 - nb) and int(tm2.num_blocks) == nb - n_out
    assert remap is not None and int((remap >= 0).sum()) == nb - n_out
    assert bool((remap[torch.from_numpy(vis).long()] >= 0).all()), "a block just seen was evicted"
    assert all(t.dtype == tm.tsdf.dtype for t, _, _ in cache.store.values())
    for c, (t, w, col) in cache.store.items():
        old = int(tbm.lookup(tm, torch.tensor([c], dtype=torch.int32), tcfg.coord_bits)[0])
        assert torch.equal(t, tm.tsdf[old]) and torch.equal(w, tm.weight[old])
        assert torch.equal(col, tm.color[old])

    # A camera behind the blocks that sees them all restores the store in
    # two batches.
    T = np.eye(4)
    T[:3, 3] = [0.0, 0.0, -1.5]
    for _ in range(2):
        tm2 = cache.before_step(tm2, T)
    restored = n_out - cache.n_host_blocks
    assert restored > 0
    slot, found = tbm.lookup(tm2, tm.block_coords[:nb], tcfg.coord_bits)
    back = found.numpy()
    assert back.sum() == nb - cache.n_host_blocks
    was_out = (remap < 0)[:nb] & found
    assert int(was_out.sum()) == restored
    assert_restored(tm2, slot[was_out], tm.tsdf[:nb][was_out], tm.weight[:nb][was_out],
                    tm.color[:nb][was_out])
    kept = (remap >= 0)[:nb]
    for pool, orig in ((tm2.tsdf, tm.tsdf), (tm2.weight, tm.weight), (tm2.color, tm.color)):
        assert torch.equal(pool[slot[kept].long()], orig[:nb][kept])


# ----------------------------------------------------------------- the sweep
FWD = 14        # forward frames; the camera then returns the same way
CAP = 1 << 11   # the JAX test's capped pool, with its batch sizes
EVICT, RESTORE = 512, 256


def jax_state_numpy(state):
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in state._asdict().items()}


@functools.lru_cache(maxsize=None)
def sweep_frames(n_fwd=FWD, sway_of=36):
    """tests/test_swap.py's corridor sweep (pitched camera, 6 cm steps, the
    sway of a ``sway_of``-frame trajectory; its own has 36), cut to
    ``n_fwd`` frames out and back."""
    cam = tiny_test_config().camera
    pitch = np.asarray(se3_exp(jnp.asarray([0.35, 0, 0, 0, 0, 0], jnp.float32)))
    scene = corridor_scene(length_m=6.5, box_every=0.35)
    fwd = [T @ pitch for T in sweep_trajectory(sway_of, step_m=0.06)][:n_fwd]
    gt = fwd + fwd[::-1][1:]
    frames = [np.array(scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32))) for T in gt]
    return gt, frames


def port_cache_like(jc: JaxCache, tcfg) -> HostBlockCache:
    """The port's cache in the state of a JAX cache."""
    c = HostBlockCache(tcfg.blockmap, tcfg.tsdf, tcfg.camera, evict_batch=jc.evict_batch,
                       restore_batch=jc.restore_batch, device="cpu")
    assert c.headroom == jc.headroom
    c.store = {k: tuple(None if a is None else _to_tensor(a, "cpu") for a in v)
               for k, v in jc.store.items()}
    c.last_seen = jc.last_seen.copy()
    c._frame = jc._frame
    return c


@pytest.fixture(scope="module")
def forced_sweep():
    """The JAX sweep with its cache, and for every frame the port's
    restore -> step -> evict from the JAX state and cache before it."""
    cfg = sweep_cfg(CAP)
    tcfg = config_from_reference(cfg)
    gt, frames = sweep_frames()
    jp, tp = JaxPipeline(cfg), BlockPipeline(tcfg, device="cpu")
    jc = JaxCache(cfg.blockmap, cfg.tsdf, cfg.camera, evict_batch=EVICT, restore_batch=RESTORE)
    js = jp.init()
    rows, T_prev = [], np.eye(4, dtype=np.float32)
    for f in frames:
        # The port, from the JAX state and cache as they are now.
        tc = port_cache_like(jc, tcfg)
        ts = block_state_from_numpy(jax_state_numpy(js), device="cpu")
        n0 = tc.n_host_blocks
        ts = tp.write_map(ts, tc.before_step(ts.block_map(), T_prev))
        t_restored = n0 - tc.n_host_blocks
        ts, ta = tp.step(ts, torch.from_numpy(f))
        n1 = tc.n_host_blocks
        tm, tremap = tc.after_step(ts.block_map(), ts.vis_slots)

        # The JAX package on the same frame.
        n0 = jc.n_host_blocks
        js = jp.write_map(js, jc.before_step(js.block_map(), T_prev))
        j_restored = n0 - jc.n_host_blocks
        js, ja = jp.step(js, jnp.asarray(f))
        T_prev = np.asarray(js.T_wc)
        j_n1 = jc.n_host_blocks
        jm, jremap = jc.after_step(js.block_map(), np.asarray(js.vis_slots))
        rows.append(dict(
            t_restored=t_restored, j_restored=j_restored,
            t_evicted=tc.n_host_blocks - n1, j_evicted=jc.n_host_blocks - j_n1,
            t_pose=ts.T_wc.numpy().copy(), j_pose=T_prev, ta=ta, ja=jax.tree.map(np.asarray, ja),
            tm=tm, jm=jax.tree.map(np.asarray, jm),
            tremap=None if tremap is None else tremap.numpy(),
            jremap=None if jremap is None else np.asarray(jremap),
            t_keys=list(tc.store.keys()), j_keys=list(jc.store.keys()),
            t_seen=tc.last_seen.copy(), j_seen=jc.last_seen.copy(),
        ))
        js = jp.write_map(js, jm)
        if jremap is not None:
            vs, r = np.asarray(js.vis_slots), np.asarray(jremap)
            vs = np.where(vs >= 0, r[np.clip(vs, 0, len(r) - 1)], -1)
            js = js._replace(vis_slots=jnp.asarray(vs, jnp.int32))
    return rows


@pytest.mark.parametrize("frame", range(2 * FWD - 1))
def test_sweep_frame_follows_jax(forced_sweep, frame):
    """One frame of restore -> step -> evict from the JAX state: the same
    blocks restored and evicted, nothing dropped, the pose within 0.25 mm
    of the JAX step (measured: under 5e-7 m but for 1.0e-4 m at frame 2
    and 3.7e-5 m at the last), and after the eviction the same
    hash table, coords, live count, remap, store keys and recency."""
    r = forced_sweep[frame]
    assert r["t_restored"] == r["j_restored"] and r["t_evicted"] == r["j_evicted"]
    assert bool(r["ta"].ok) and bool(r["ja"].ok)
    assert int(r["ta"].blocks_dropped) == int(r["ja"].blocks_dropped) == 0
    assert np.abs(r["t_pose"][:3, 3] - r["j_pose"][:3, 3]).max() <= 2.5e-4
    for name in ("num_blocks", "blocks_allocated", "num_visible"):
        assert int(getattr(r["ta"], name)) == int(getattr(r["ja"], name)), name
    tm, jm = r["tm"], r["jm"]
    for name in ("bucket_keys", "bucket_slots", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), getattr(jm, name), err_msg=name)
    assert (r["tremap"] is None) == (r["jremap"] is None)
    if r["jremap"] is not None:
        np.testing.assert_array_equal(r["tremap"], r["jremap"])
    assert r["t_keys"] == r["j_keys"]
    np.testing.assert_array_equal(r["t_seen"], r["j_seen"])
    # The pools (float32 here): the same rows moved.  Their values follow
    # a voxel's camera depth over mu = 0.04 m.  The jitted JAX step takes
    # the depth as an FMA chain (up to 2e-6 m apart at 2 m under this
    # pitched camera), and on two frames of this sweep ICP turns the ulps
    # into a pose 0.1 mm apart (frame 2: 1.0e-4 m, 1.1e-4 rad), which moves
    # every depth by up to ten times the pose's largest entry difference.
    # More than that only for the voxels whose projection rounds to
    # another pixel (at most 0.1% of them).
    gap = np.abs(r["t_pose"][:3] - r["j_pose"][:3]).max()
    tol = max(5e-5, 10.0 * gap / 0.04)
    assert (np.abs(tm.tsdf.numpy() - jm.tsdf) > tol).mean() <= 1e-3
    assert (tm.weight.numpy() != jm.weight).mean() <= 1e-3


def test_sweep_evicts_and_restores(forced_sweep):
    """Both directions of the swap fired, the restores on the return leg."""
    assert sum(r["t_evicted"] for r in forced_sweep) > 500
    assert sum(r["t_restored"] for r in forced_sweep[FWD:]) > 100


def run_port_sweep(cfg, frames, cache=None):
    """tests/test_swap.py's loop on the port, the remap of the aged visible
    list included: (poses, final state, blocks dropped, restored per frame)."""
    pipe = BlockPipeline(cfg, device="cpu")
    state = pipe.init()
    poses, dropped, restored = [], 0, []
    for f in frames:
        if cache is not None:
            n0 = cache.n_host_blocks
            T_pred = poses[-1] if poses else np.eye(4, dtype=np.float32)
            state = pipe.write_map(state, cache.before_step(state.block_map(), T_pred))
            restored.append(n0 - cache.n_host_blocks)
        state, aux = pipe.step(state, torch.from_numpy(f))
        assert bool(aux.ok)
        dropped += int(aux.blocks_dropped)
        poses.append(state.T_wc.numpy().copy())
        if cache is not None:
            m, remap = cache.after_step(state.block_map(), state.vis_slots)
            state = pipe.write_map(state, m)
            if remap is not None:
                vs = state.vis_slots
                state = state._replace(
                    vis_slots=torch.where(vs >= 0, remap[vs.clamp(min=0).long()], -1))
    return poses, state, dropped, restored


def test_port_sweep_beyond_capacity_matches_uncapped():
    """tests/test_swap.py's acceptance test on the port alone,
    free-running, with its pool and batch sizes: the scene's block count
    exceeds 1.2 x the capped pool, nothing is dropped, the overflow lives
    on the host, live + host blocks cover 95% of the scene, and the
    trajectory error is that of the uncapped run (x 1.2 + 0.2 mm).  20
    frames out and 19 back with half the sway of the JAX test's 36: at
    80x64 a free-running tracker slips by centimetres on that one's 16th
    frame (see the module docstring), which inflates the uncapped count."""
    n_fwd = 20
    gt, frames = sweep_frames(n_fwd, sway_of=72)
    ref_poses, s_ref, _, _ = run_port_sweep(config_from_reference(sweep_cfg(1 << 13)), frames)
    total = int(s_ref.num_blocks)
    assert total > 1.2 * CAP, f"premise: the scene has {total} blocks"
    small = config_from_reference(sweep_cfg(CAP))
    cache = HostBlockCache(small.blockmap, small.tsdf, small.camera, evict_batch=EVICT,
                           restore_batch=RESTORE, device="cpu")
    poses, s, dropped, restored = run_port_sweep(small, frames, cache)
    assert dropped == 0
    assert cache.n_host_blocks > 0 and sum(restored[n_fwd:]) > 0
    assert int(s.num_blocks) + cache.n_host_blocks >= int(0.95 * total)
    ate_ref = ate_rmse(ref_poses, gt, align=False)
    ate = ate_rmse(poses, gt, align=False)
    assert ate <= 1.2 * ate_ref + 2e-4, (ate, ate_ref)


def test_cache_defaults_to_the_card():
    tb = config_from_reference(tiny_test_config())
    if torch.cuda.is_available():
        assert HostBlockCache(tb.blockmap, tb.tsdf, tb.camera).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            HostBlockCache(tb.blockmap, tb.tsdf, tb.camera)
    assert HostBlockCache(tb.blockmap, tb.tsdf, tb.camera, device="cpu").device.type == "cpu"
