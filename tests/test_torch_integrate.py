"""The integrate step: the port's plain ``integrate_blocks`` against the
JAX package's XLA ``integrate_blocks`` and its Pallas kernel
``integrate_blocks_pallas`` (interpret mode), over the whole pool
including the sacrificial row; and the CUDA kernel wrapper's CPU path.

The kernel itself runs only on a card: tests/test_torch_cuda.py (which
imports no jax) holds it against the plain version to the bit.
"""

import dataclasses
import inspect

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
from topfusion_tpu.ops.pallas.integrate_kernel import integrate_blocks_pallas
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import tsdf_block as ttb
from topfusion_tpu_torch.ops.cuda import integrate as cuda_integrate
from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda, launch_plan

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def seq():
    """JAX map (float32 pool) after 3 frames, the 4th frame's metric depth
    and pose, and its full-scan visible set."""
    cfg = make_cfg()
    scene = SyntheticScene()
    poses = orbit_trajectory(4, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in poses]
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    for f in frames[:3]:
        state, _ = pipe.step(state, jnp.asarray(f))
    m = state.block_map()
    T = np.asarray(poses[3], np.float32)
    raw = np.asarray(j_depth_to_meters(jnp.asarray(frames[3])))
    vis = tuple(np.asarray(v) for v in jtb.visible_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.asarray(T)))
    pool = {f: np.asarray(getattr(m, f)) for f in jbm.BlockMap._fields}
    return cfg, pool, raw, T, vis


def make_case(seq, dtype, stop_at_max):
    """(jax cfg, port cfg, jax map, numpy pool fields) for a pool dtype
    and weight rule; max_weight 2 makes the weight clamp and the
    stop-at-max gate bite after 3 frames."""
    cfg, pool, raw, T, vis = seq
    cfg = dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, max_weight=2.0,
                                 stop_integrating_at_max_weight=stop_at_max),
        blockmap=dataclasses.replace(cfg.blockmap, pool_dtype=dtype),
    )
    pool = dict(pool)
    jd = jnp.dtype(dtype)
    pool["tsdf"] = np.asarray(jbm.encode_tsdf(jnp.asarray(pool["tsdf"]), jd))
    pool["weight"] = np.asarray(jbm.encode_weight(jnp.minimum(jnp.asarray(pool["weight"]), 2.0), jd))
    mj = jbm.BlockMap(*[jnp.asarray(pool[f]) for f in jbm.BlockMap._fields])
    return cfg, config_from_reference(cfg), mj, pool


def port_map(pool):
    return tbm.BlockMap(*[t(pool[f]) for f in tbm.BlockMap._fields])


CASES = [(d, s) for d in ("int16", "float32") for s in (False, True)]


@pytest.mark.parametrize("dtype,stop_at_max", CASES)
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_integrate_matches_jax(seq, dtype, stop_at_max, reference):
    """The whole pool is bit-equal on the CPU, tighter than the one int16
    quantum (float32: 1e-6) the port allows: both packages evaluate the
    same float32 expressions in the same order, and XLA's CPU backend
    does not contract the fusion rule's multiply-add here."""
    _, _, raw, T, vis = seq
    jc, tc, mj, pool = make_case(seq, dtype, stop_at_max)
    if reference == "xla":
        out_j, n_j = jtb.integrate_blocks(mj, jc.camera, jc.tsdf, jc.blockmap,
                                          jnp.asarray(T), jnp.asarray(raw),
                                          tuple(jnp.asarray(v) for v in vis))
    else:
        out_j, n_j = integrate_blocks_pallas(mj, jc.camera, jc.tsdf, jc.blockmap,
                                             jnp.asarray(T), jnp.asarray(raw),
                                             tuple(jnp.asarray(v) for v in vis),
                                             interpret=True)
    mt = port_map(pool)
    out_t, n_t = ttb.integrate_blocks(mt, tc.camera, tc.tsdf, tc.blockmap,
                                      t(T), t(raw), tuple(t(v) for v in vis))
    assert int(n_t) == int(n_j) > 100
    w_j, w_t = np.asarray(out_j.weight), out_t.weight.numpy()
    np.testing.assert_array_equal(w_t, w_j)
    updated = int((w_j != pool["weight"]).sum())
    assert updated > 1000
    np.testing.assert_array_equal(out_t.tsdf.numpy(), np.asarray(out_j.tsdf))
    if stop_at_max:
        full = pool["weight"] >= 2
        np.testing.assert_array_equal(out_t.tsdf.numpy()[full], pool["tsdf"][full])


@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
def test_integrate_in_place_and_untouched_rows(seq, dtype):
    """The plain path writes the pool in place, touches only visible rows,
    and leaves the sacrificial row as it was."""
    cfg, pool, raw, T, vis = seq
    jc, tc, _, _ = make_case(seq, "float32", False)
    mt = tbm.make_block_map(tc.blockmap, dtype=tbm.pool_dtype(dtype))
    src = port_map(pool)
    mt = mt._replace(**{f: getattr(src, f) for f in ("bucket_keys", "bucket_slots",
                                                      "block_coords", "num_blocks")})
    mt = mt._replace(tsdf=tbm.encode_tsdf(tbm.decode_tsdf(src.tsdf), mt.tsdf.dtype),
                     weight=tbm.encode_weight(src.weight.clamp(max=2), mt.weight.dtype))
    before_t, before_w = mt.tsdf.clone(), mt.weight.clone()
    out, n = ttb.integrate_blocks(mt, tc.camera, tc.tsdf, tc.blockmap, t(T), t(raw),
                                  tuple(t(v) for v in vis))
    assert out.tsdf.data_ptr() == mt.tsdf.data_ptr()
    changed_rows = torch.nonzero((out.weight != before_w).flatten(1).any(1)).flatten()
    slots, _, mask = vis
    assert set(changed_rows.tolist()) <= set(slots[mask].tolist())
    cap = mt.capacity
    assert torch.equal(out.tsdf[cap], before_t[cap]) and torch.equal(out.weight[cap], before_w[cap])

    # Nothing visible: the pool is bit-identical.
    T_far = T.copy()
    T_far[0, 3] += 50.0
    vis_far = ttb.visible_blocks(out, tc.camera, tc.tsdf, tc.blockmap, t(T_far))
    assert not bool(vis_far[2].any())
    snap_t, snap_w = out.tsdf.clone(), out.weight.clone()
    _, n_far = ttb.integrate_blocks(out, tc.camera, tc.tsdf, tc.blockmap, t(T_far), t(raw), vis_far)
    assert int(n_far) == 0
    assert torch.equal(out.tsdf, snap_t) and torch.equal(out.weight, snap_w)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_wrapper_runs_plain_on_cpu(seq, dtype):
    """On CPU tensors the kernel wrapper is the plain version, and it
    launches nothing."""
    _, _, raw, T, vis = seq
    _, tc, _, pool = make_case(seq, dtype, False)
    a, na = ttb.integrate_blocks(port_map(pool), tc.camera, tc.tsdf, tc.blockmap,
                                 t(T), t(raw), tuple(t(v) for v in vis))
    before = (integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
    b, nb = integrate_blocks_cuda(port_map(pool), tc.camera, tc.tsdf, tc.blockmap,
                                  t(T), t(raw), tuple(t(v) for v in vis))
    assert (integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches) == before
    assert int(na) == int(nb)
    assert torch.equal(a.tsdf, b.tsdf) and torch.equal(a.weight, b.weight)


# ------------------------------------------------- the kernel's launch plan
@pytest.mark.parametrize("block_size", [4, 8])
@pytest.mark.parametrize("num_entries", [0, 1, 5, 4096])
def test_launch_plan_covers_every_entry_once(num_entries, block_size):
    """Blocks of 8^3 take the column kernel (64 threads per entry, two
    entries per CTA of 128), any other size the per-voxel kernel (one CTA
    of B^3 threads per entry); the grid reaches every entry, none twice,
    and is empty only for an empty list."""
    plan = launch_plan(num_entries, block_size)
    if block_size == 8:
        assert plan.path == "column" and plan.entries_per_cta == 2
        assert plan.block == 128 == plan.entries_per_cta * block_size ** 2
    else:
        assert plan.path == "voxel" and plan.entries_per_cta == 1
        assert plan.block == block_size ** 3
    assert plan.block <= 1024 and plan.block % 32 == 0
    served = [cta * plan.entries_per_cta + i
              for cta in range(plan.grid) for i in range(plan.entries_per_cta)]
    assert len(set(served)) == len(served)
    assert set(range(num_entries)) <= set(served)
    # No CTA without an entry: the grid is the least that covers the list.
    assert (plan.grid - 1) * plan.entries_per_cta < num_entries or plan.grid == 0
    assert (plan.grid == 0) == (num_entries == 0)


@pytest.mark.parametrize("num_entries,block_size", [(16, 11), (16, 0), (-1, 8)])
def test_launch_plan_refuses(num_entries, block_size):
    """More voxels than a CTA has threads, no voxels, a negative list."""
    with pytest.raises(ValueError):
        launch_plan(num_entries, block_size)


@pytest.mark.parametrize("dtype", ["int16", "bfloat16", "float32"])
def test_z_column_is_contiguous_and_aligned(dtype):
    """The layout the column kernel rests on: the z-column (x, y) of pool
    row ``slot`` is 8 contiguous elements at element offset
    slot*512 + x*64 + y*8, so 16 bytes at a 16-byte boundary in a 2-byte
    pool (32 at a 32-byte boundary in float32)."""
    cfg = dataclasses.replace(config_from_reference(make_cfg()).blockmap,
                              capacity=64, pool_dtype=dtype)
    m = tbm.make_block_map(cfg)
    assert cfg.block_size == 8 and tuple(m.tsdf.shape) == (65, 8, 8, 8)
    size = m.tsdf.element_size()
    for pool in (m.tsdf, m.weight):
        assert pool.is_contiguous() and pool.data_ptr() % 16 == 0
        flat = pool.view(-1)
        for slot, x, y in [(0, 0, 0), (3, 5, 7), (63, 7, 0), (64, 2, 6)]:
            col = pool[slot, x, y, :]
            offset = slot * 512 + x * 64 + y * 8
            assert col.shape == (8,) and col.stride() == (1,)
            assert col.storage_offset() == offset
            assert col.data_ptr() == flat[offset:].data_ptr()
            assert (col.data_ptr() - pool.data_ptr()) % (8 * size) == 0
            assert col.data_ptr() % 16 == 0


def test_bfloat16_codec_round_trips_every_finite_value():
    """encode(decode(a)) == a for every finite bfloat16 (tsdf and weight):
    with the int16 round trip of tests/test_torch_blockmap.py, what lets
    the kernel leave untouched voxels unwritten."""
    bits = np.arange(-32768, 32768, dtype=np.int16)
    a = t(bits).view(torch.bfloat16)
    finite = torch.isfinite(a.to(torch.float32))
    assert int(finite.sum()) == 65536 - 2 * 128
    for dec, enc in ((tbm.decode_tsdf, tbm.encode_tsdf), (tbm.decode_weight, tbm.encode_weight)):
        back = enc(dec(a), torch.bfloat16)
        assert torch.equal(back.view(torch.int16)[finite], a.view(torch.int16)[finite])


def test_int16_weight_codec_round_trips():
    """Every weight an int16 pool can hold (0..32767) survives the codec."""
    w = t(np.arange(0, 32768, dtype=np.int16))
    assert torch.equal(tbm.encode_weight(tbm.decode_weight(w), torch.int16), w)


def test_wrapper_leaves_the_pose_inverse_to_the_kernel():
    """The wrapper hands T_wc to the kernel as it is: it neither inverts
    the pose nor copies an argument into a contiguous one."""
    assert not hasattr(cuda_integrate, "se3_inverse")
    src = inspect.getsource(integrate_blocks_cuda) + inspect.getsource(cuda_integrate.launch_kernel)
    assert "se3_inverse" not in src and ".contiguous()" not in src
    assert "T_wc.data_ptr()" in src
