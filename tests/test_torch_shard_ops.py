"""The ops' ``shard = (shard_id, num_shards)`` arguments against the JAX
package's, in one process and without collectives: hash ownership
(``_bucket_owner``), ``lookup``, ``allocate``, the voxel reads,
``sample_trilinear``, ``evict_blocks`` / ``insert_blocks`` and
``allocate_from_depth``, for every shard of 2 and of 4, the JAX
functions called eagerly with the same Python-int shard tuples.  The
map's arrays are integer results and must agree exactly; so must the
reads, which gather stored values (the trilinear sum as well: eager JAX
rounds it as the port does)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.io.synthetic import SyntheticScene
from topfusion_tpu.ops import blockmap as jbm
from topfusion_tpu.ops import swap as jsw
from topfusion_tpu.ops import tsdf_block as jtb
from topfusion_tpu.ops.depth import depth_to_meters as j_depth_to_meters
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import swap as tsw
from topfusion_tpu_torch.ops import tsdf_block as ttb

torch.set_num_threads(2)

SHARDS = [(s, ns) for ns in (2, 4) for s in range(ns)]
LOCAL_CAPACITY = 1 << 9


def t(a):
    return torch.from_numpy(np.array(a))


def assert_fields_equal(got, want, what):
    for name, g, w in zip(type(want)._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{what}.{name}")


def local_cfg():
    return dataclasses.replace(make_cfg().blockmap, capacity=LOCAL_CAPACITY,
                               max_new_blocks_per_frame=256, max_visible_blocks=256)


@pytest.fixture(scope="module", params=SHARDS, ids=[f"{s}of{ns}" for s, ns in SHARDS])
def shard_map(request):
    """One shard's local map in both packages after two ownership-filtered
    allocations of random candidates, with random pool and color data."""
    shard = request.param
    cfg = local_cfg()
    rng = np.random.default_rng(10 + 10 * shard[1] + shard[0])
    mj = jbm.make_block_map(cfg, use_color=True)
    mt = tbm.make_block_map(cfg, use_color=True)
    for _ in range(2):
        c = rng.integers(-9, 9, size=(1500, 3)).astype(np.int32)
        valid = rng.uniform(size=len(c)) > 0.1
        mj, ij = jbm.allocate(mj, jnp.asarray(c), jnp.asarray(valid), cfg, shard=shard,
                              return_touched=True)
        mt, it = tbm.allocate(mt, t(c), t(valid), cfg, shard=shard, return_touched=True)
        assert_fields_equal(it, ij, "AllocInfo")
        assert_fields_equal(mt, mj, "BlockMap")
    rows = mt.tsdf.shape
    tsdf = rng.uniform(-1, 1, size=rows).astype(np.float32)
    weight = rng.integers(0, 5, size=rows).astype(np.float32)
    color = rng.uniform(0, 1, size=rows + (3,)).astype(np.float32)
    mj = mj._replace(tsdf=jnp.asarray(tsdf), weight=jnp.asarray(weight), color=jnp.asarray(color))
    mt = mt._replace(tsdf=t(tsdf), weight=t(weight), color=t(color))
    return dict(shard=shard, cfg=cfg, mj=mj, mt=mt, rng=rng)


@pytest.mark.parametrize("shard", SHARDS, ids=[f"{s}of{ns}" for s, ns in SHARDS])
def test_bucket_owner_matches_jax(shard):
    c = np.random.default_rng(1).integers(-512, 512, size=(5000, 3)).astype(np.int32)
    bj, mj = jbm._bucket_owner(jnp.asarray(c), LOCAL_CAPACITY, shard)
    bt, mt = tbm._bucket_owner(t(c), LOCAL_CAPACITY, shard)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < mt.float().mean() < 1
    assert int(bt.max()) < LOCAL_CAPACITY


def test_ownership_partitions_the_blocks():
    """Every block is owned by exactly one shard of 4."""
    c = t(np.random.default_rng(2).integers(-100, 100, size=(4000, 3)).astype(np.int32))
    owners = torch.stack([tbm._bucket_owner(c, LOCAL_CAPACITY, (s, 4))[1] for s in range(4)])
    assert torch.equal(owners.sum(0), torch.ones(4000, dtype=torch.int64))


def test_allocated_map_is_owned(shard_map):
    """The fixture's allocations matched the JAX package's; every live
    block is this shard's."""
    mt, shard = shard_map["mt"], shard_map["shard"]
    n = int(mt.num_blocks)
    assert n > 50
    assert bool(tbm._bucket_owner(mt.block_coords[:n], LOCAL_CAPACITY, shard)[1].all())


def test_lookup_matches_jax(shard_map):
    mj, mt, shard = shard_map["mj"], shard_map["mt"], shard_map["shard"]
    n = int(mt.num_blocks)
    rng = np.random.default_rng(5)
    coords = np.concatenate([mt.block_coords[:n].numpy(),
                             rng.integers(-12, 12, size=(400, 3))]).astype(np.int32)
    bits = shard_map["cfg"].coord_bits
    sj, fj = jbm.lookup(mj, jnp.asarray(coords), bits, shard=shard)
    st, ft = tbm.lookup(mt, t(coords), bits, shard=shard)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert bool(ft[:n].all()) and not bool(ft[n:].all())


def voxel_queries(shard_map, size=3000):
    rng = np.random.default_rng(6)
    return rng.integers(-80, 80, size=(size, 3)).astype(np.int32)


def test_read_voxels_nearest_matches_jax(shard_map):
    mj, mt, shard = shard_map["mj"], shard_map["mt"], shard_map["shard"]
    v = voxel_queries(shard_map)
    bits = shard_map["cfg"].coord_bits
    oj = jbm.read_voxels_nearest(mj, jnp.asarray(v), bits, shard=shard)
    ot = tbm.read_voxels_nearest(mt, t(v), bits, shard=shard)
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < ot[2].float().mean() < 1


def test_read_color_nearest_matches_jax(shard_map):
    mj, mt, shard = shard_map["mj"], shard_map["mt"], shard_map["shard"]
    v = voxel_queries(shard_map)
    bits = shard_map["cfg"].coord_bits
    cj = jbm.read_color_nearest(mj, jnp.asarray(v), bits, shard=shard)
    ct = tbm.read_color_nearest(mt, t(v), bits, shard=shard)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_sample_trilinear_matches_jax(shard_map):
    mj, mt, shard = shard_map["mj"], shard_map["mt"], shard_map["shard"]
    pv = np.random.default_rng(7).uniform(-70, 70, size=(3000, 3)).astype(np.float32)
    bits = shard_map["cfg"].coord_bits
    tj, wj = jbm.sample_trilinear(mj, jnp.asarray(pv), bits, shard=shard)
    tt, wt = tbm.sample_trilinear(mt, t(pv), bits, shard=shard)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_evict_blocks_matches_jax(shard_map):
    """Evict a third of the live blocks: the compacted map, rebuilt in the
    global bucket space, and the remap equal the JAX package's, and every
    kept block is still found."""
    mj, mt, shard, cfg = shard_map["mj"], shard_map["mt"], shard_map["shard"], shard_map["cfg"]
    n = int(mt.num_blocks)
    slots = np.full(256, -1, np.int32)
    pick = np.random.default_rng(8).permutation(n)[: n // 3].astype(np.int32)
    slots[: len(pick)] = pick
    m2j, rj = jsw.evict_blocks(mj, jnp.asarray(slots), cfg, shard=shard)
    m2t, rt = tsw.evict_blocks(mt, t(slots), cfg, shard=shard)
    assert_fields_equal(m2t, m2j, "evicted map")
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    kept = m2t.block_coords[: int(m2t.num_blocks)]
    _, found = tbm.lookup(m2t, kept, cfg.coord_bits, shard=shard)
    assert bool(found.all())


def test_insert_blocks_matches_jax(shard_map):
    """Restore a batch of blocks, some this shard's and some not, some
    already live: only valid blocks of this shard's are restored (those
    that fit the pool and their buckets), as in the JAX package."""
    mj, mt, shard, cfg = shard_map["mj"], shard_map["mt"], shard_map["shard"], shard_map["cfg"]
    rng = np.random.default_rng(9)
    k, b = 64, cfg.block_size
    n = int(mt.num_blocks)
    coords = np.concatenate([mt.block_coords[:8].numpy(),
                             rng.integers(-30, 30, size=(k - 8, 3))]).astype(np.int32)
    valid = rng.uniform(size=k) > 0.2
    tsdf = rng.uniform(-1, 1, size=(k, b, b, b)).astype(np.float32)
    weight = rng.integers(0, 4, size=(k, b, b, b)).astype(np.float32)
    color = rng.uniform(0, 1, size=(k, b, b, b, 3)).astype(np.float32)
    bj = jsw.ExtractedBlocks(coords=jnp.asarray(coords), tsdf=jnp.asarray(tsdf),
                             weight=jnp.asarray(weight), color=jnp.asarray(color),
                             valid=jnp.asarray(valid))
    bt = tsw.ExtractedBlocks(coords=t(coords), tsdf=t(tsdf), weight=t(weight), color=t(color),
                             valid=t(valid))
    m2j, okj = jsw.insert_blocks(mj, bj, cfg, 100.0, shard=shard)
    m2t, okt = tsw.insert_blocks(mt, bt, cfg, 100.0, shard=shard)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert_fields_equal(m2t, m2j, "restored map")
    owned = tbm._bucket_owner(t(coords), LOCAL_CAPACITY, shard)[1].numpy()
    ok = okt.numpy()
    assert ok.any() and not (ok & ~(owned & valid)).any()
    assert int(m2t.num_blocks) > n


@pytest.fixture(scope="module")
def depth_case():
    cfg = make_cfg()
    scene = SyntheticScene()
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.01, -0.02, 0.0]
    raw = np.asarray(j_depth_to_meters(scene.render_depth_mm(cfg.camera, jnp.asarray(T))))
    return cfg, config_from_reference(cfg), T, raw


@pytest.mark.parametrize("shard", SHARDS, ids=[f"{s}of{ns}" for s, ns in SHARDS])
def test_allocate_from_depth_matches_jax(depth_case, shard):
    """Ownership-filtered allocation over the whole frame (no row split)."""
    jc, tc, T, raw = depth_case
    bm_j = dataclasses.replace(jc.blockmap, capacity=1 << 10, max_visible_blocks=512)
    bm_t = dataclasses.replace(tc.blockmap, capacity=1 << 10, max_visible_blocks=512)
    mj, ij = jtb.allocate_from_depth(jbm.make_block_map(bm_j), jc.camera, jc.tsdf, bm_j,
                                     jnp.asarray(T), jnp.asarray(raw), shard=shard,
                                     return_touched=True)
    mt, it = ttb.allocate_from_depth(tbm.make_block_map(bm_t), tc.camera, tc.tsdf, bm_t,
                                     t(T), t(raw), shard=shard, return_touched=True)
    assert int(it.n_inserted) > 0
    assert_fields_equal(it, ij, "AllocInfo")
    assert_fields_equal(mt, mj, "BlockMap")
