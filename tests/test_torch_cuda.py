"""The port's CUDA integrate kernel on the card, held to the bit against
its plain PyTorch version over the whole pool.

This file imports no jax, so it runs on a GPU machine without it
(``tests/conftest.py`` imports jax, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card the ``cuda`` tests skip.
"""

import dataclasses
import warnings

import pytest
import torch

from topfusion_tpu_torch.config import (
    BlockMapConfig,
    CameraConfig,
    DenseVolumeConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion_tpu_torch.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import tsdf_block as ttb
from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
from topfusion_tpu_torch.ops.depth import depth_to_meters


def small_cfg(pool_dtype="float32", max_weight=2.0, stop_at_max=False):
    """The 80x64 configuration of tests/test_pipeline_block.py (plain
    integrate), with a low max_weight so the weight rules bite."""
    return PipelineConfig(
        camera=CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0),
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(6, 4, 3)),
        dense=DenseVolumeConfig(dims=(96, 96, 96), origin=(-0.48, -0.48, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04, max_weight=max_weight,
                        stop_integrating_at_max_weight=stop_at_max),
        blockmap=BlockMapConfig(capacity=1 << 13, max_new_blocks_per_frame=2048,
                                max_visible_blocks=1 << 12, alloc_pixel_stride=1,
                                alloc_steps=6, pool_dtype=pool_dtype,
                                use_pallas_integrate=False),
        raycast=RaycastConfig(max_steps=160),
    )


@pytest.fixture(scope="module")
def mapped():
    """A map after 3 frames on the card, the 4th frame's depth and pose,
    and its visible set."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA integrate kernel runs only on an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = small_cfg()
    poses = orbit_trajectory(4, max_angle_deg=4.0, max_shift=0.04, seed=3)
    scene = SyntheticScene()
    frames = [scene.render_depth_mm(cfg.camera, torch.as_tensor(T, device=dev)) for T in poses]
    pipe = BlockPipeline(cfg, dev)
    state = pipe.init()
    for f in frames[:3]:
        state, _ = pipe.step(state, f)
    T = torch.as_tensor(poses[3], device=dev)
    raw = depth_to_meters(frames[3])
    m = state.block_map()
    vis = ttb.visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T, depth=raw)
    return m, T, raw, vis, (pipe, state, frames[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
@pytest.mark.parametrize("stop_at_max", [False, True])
def test_kernel_matches_plain(mapped, dtype, stop_at_max):
    m, T, raw, vis, _ = mapped
    cfg = small_cfg(dtype, stop_at_max=stop_at_max)
    dt = tbm.pool_dtype(dtype)
    m = m._replace(tsdf=tbm.encode_tsdf(tbm.decode_tsdf(m.tsdf), dt),
                   weight=tbm.encode_weight(tbm.decode_weight(m.weight).clamp(max=2), dt))
    args = (cfg.camera, cfg.tsdf, cfg.blockmap, T, raw, vis)
    before = integrate_blocks_cuda.launches
    k, nk = integrate_blocks_cuda(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    p, np_ = ttb.integrate_blocks(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    torch.cuda.synchronize()
    assert integrate_blocks_cuda.launches == before + 1
    assert int(nk) == int(np_) > 100
    assert int((p.weight != m.weight).sum()) > 1000
    assert torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(mapped):
    m, T, raw, vis, _ = mapped
    cfg = small_cfg()
    slots, coords, mask = vis
    bad = [
        ("depth dtype", dict(depth=raw.double())),
        ("depth layout", dict(depth=raw.t().contiguous().t())),
        ("slots dtype", dict(vis=(slots.long(), coords, mask))),
        ("pool device", dict(m=m._replace(tsdf=m.tsdf.cpu()))),
        ("pool dtypes", dict(m=m._replace(weight=m.weight.to(torch.int16)))),
    ]
    for what, change in bad:
        kw = dict(m=m, depth=raw, vis=vis) | change
        with pytest.raises(ValueError):
            integrate_blocks_cuda(kw["m"], cfg.camera, cfg.tsdf, cfg.blockmap, T,
                                  kw["depth"], kw["vis"])


@pytest.mark.cuda
def test_empty_visible_set_launches_nothing(mapped):
    """V = 0 is no launch: the pool is untouched and the count stays."""
    m, T, raw, vis, _ = mapped
    cfg = small_cfg()
    snap_t, snap_w = m.tsdf.clone(), m.weight.clone()
    before = integrate_blocks_cuda.launches
    out, n = integrate_blocks_cuda(m, cfg.camera, cfg.tsdf, cfg.blockmap, T, raw,
                                   tuple(v[:0] for v in vis))
    assert integrate_blocks_cuda.launches == before
    assert int(n) == 0
    assert torch.equal(out.tsdf, snap_t) and torch.equal(out.weight, snap_w)


@pytest.mark.cuda
def test_step_syncs_the_host_once(mapped):
    """A pipeline step (kernel path) issues one synchronizing operation,
    ICP's eigvalsh, as far as PyTorch's sync debug mode detects."""
    _, _, _, _, (pipe, state, frame) = mapped
    pipe = BlockPipeline(dataclasses.replace(pipe.cfg, blockmap=dataclasses.replace(
        pipe.cfg.blockmap, use_pallas_integrate=None)), pipe.device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe.step(state, frame)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in rec
             if str(w.message).startswith("called a synchronizing")]
    assert len(syncs) == 1, syncs


def test_wrapper_refuses_other_devices():
    """The wrapper runs the plain version only for CPU tensors; any other
    device that is not CUDA is refused, never silently computed."""
    cfg = small_cfg()
    m = tbm.make_block_map(cfg.blockmap, device="meta")
    V = cfg.blockmap.max_visible_blocks
    vis = (torch.empty(V, dtype=torch.int32, device="meta"),
           torch.empty(V, 3, dtype=torch.int32, device="meta"),
           torch.empty(V, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        integrate_blocks_cuda(m, cfg.camera, cfg.tsdf, cfg.blockmap,
                              torch.eye(4, device="meta"),
                              torch.empty(64, 80, device="meta"), vis)


def test_small_cfg_mirrors_the_jax_test_config():
    """small_cfg is tests/test_pipeline_block.make_cfg plus the two weight
    fields and the plain integrate (this file cannot import that one)."""
    from tests.test_pipeline_block import make_cfg
    from topfusion_tpu_torch.convert import config_from_reference

    ref = config_from_reference(make_cfg())
    ours = small_cfg(max_weight=ref.tsdf.max_weight)
    ours = dataclasses.replace(ours, blockmap=dataclasses.replace(
        ours.blockmap, use_pallas_integrate=ref.blockmap.use_pallas_integrate))
    assert ours == ref
