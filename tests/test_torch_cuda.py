"""The port's CUDA integrate kernels on the card (the column kernel for
blocks of 8^3, the per-voxel kernel for any other size), held to the bit
against their plain PyTorch version over the whole pool; and the display,
color, point-cloud, dense-volume, block-swap and sharded-map paths on the
card: their host syncs, and their agreement with the same calls on the
CPU.

This file imports no jax, so it runs on a GPU machine without it
(``tests/conftest.py`` imports jax, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card the ``cuda`` tests skip.
"""

import ctypes
import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from topfusion_tpu_torch.config import (
    BlockMapConfig,
    CameraConfig,
    DenseVolumeConfig,
    ICPConfig,
    PipelineConfig,
    PoseGraphConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion_tpu_torch.convert import (
    block_state_from_numpy,
    block_state_to_numpy,
    dense_state_from_numpy,
    dense_state_to_numpy,
)
from topfusion_tpu_torch.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.models.pipeline import DensePipeline
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import tsdf_block as ttb
from topfusion_tpu_torch.ops.cuda.build import load_library
from topfusion_tpu_torch.ops.cuda.integrate import integrate_blocks_cuda
from topfusion_tpu_torch.ops.depth import depth_to_meters
from topfusion_tpu_torch.ops import swap as tsw
from topfusion_tpu_torch.ops import tsdf_dense as td
from topfusion_tpu_torch.ops.pointcloud import extract_pointcloud_blocks, extract_pointcloud_dense


def small_cfg(pool_dtype="float32", max_weight=2.0, stop_at_max=False, block_size=8):
    """The 80x64 configuration of tests/test_pipeline_block.py (plain
    integrate), with a low max_weight so the weight rules bite."""
    return PipelineConfig(
        camera=CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0),
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(6, 4, 3)),
        dense=DenseVolumeConfig(dims=(96, 96, 96), origin=(-0.48, -0.48, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04, max_weight=max_weight,
                        stop_integrating_at_max_weight=stop_at_max),
        blockmap=BlockMapConfig(block_size=block_size, capacity=1 << 13, max_new_blocks_per_frame=2048,
                                max_visible_blocks=1 << 12, alloc_pixel_stride=1,
                                alloc_steps=6, pool_dtype=pool_dtype,
                                use_pallas_integrate=False),
        raycast=RaycastConfig(max_steps=160),
    )


def map_after_three_frames(block_size):
    """A map of ``block_size``^3 blocks after 3 frames on the card, the
    4th frame's depth and pose, and its visible set."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA integrate kernel runs only on an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = small_cfg(block_size=block_size)
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


@pytest.fixture(scope="module")
def mapped():
    return map_after_three_frames(8)


@pytest.fixture(scope="module")
def mapped4():
    return map_after_three_frames(4)


def as_pool(m, cfg):
    """``m`` with its pool in ``cfg``'s dtype and weights clamped to 2."""
    dt = tbm.pool_dtype(cfg.blockmap.pool_dtype)
    return m._replace(tsdf=tbm.encode_tsdf(tbm.decode_tsdf(m.tsdf), dt),
                      weight=tbm.encode_weight(tbm.decode_weight(m.weight).clamp(max=2), dt))


def kernel_and_plain(m, cfg, T, raw, vis):
    """Both versions on clones of ``m``: (kernel map, plain map, kernel
    count, plain count, (launches, vector launches) of the kernel call)."""
    args = (cfg.camera, cfg.tsdf, cfg.blockmap, T, raw, vis)
    before = (integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
    k, nk = integrate_blocks_cuda(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    p, np_ = ttb.integrate_blocks(m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()), *args)
    torch.cuda.synchronize()
    counts = (integrate_blocks_cuda.launches - before[0],
              integrate_blocks_cuda.vector_launches - before[1])
    return k, p, int(nk), int(np_), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
@pytest.mark.parametrize("stop_at_max", [False, True])
def test_kernel_matches_plain(mapped, dtype, stop_at_max):
    m, T, raw, vis, _ = mapped
    cfg = small_cfg(dtype, stop_at_max=stop_at_max)
    m = as_pool(m, cfg)
    k, p, nk, np_, counts = kernel_and_plain(m, cfg, T, raw, vis)
    assert counts == (1, 1)  # one launch, of the column kernel
    assert nk == np_ > 100
    assert int((p.weight != m.weight).sum()) > 1000
    assert torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
@pytest.mark.parametrize("entries", ["five", "one", "none_live"])
def test_kernel_matches_plain_on_odd_lists(mapped, dtype, entries):
    """Lists that do not fill their last CTA (5 entries, 1 entry: the
    ones with the most updated voxels), and a full list whose mask is
    all false."""
    m, T, raw, vis, _ = mapped
    cfg = small_cfg(dtype)
    m = as_pool(m, cfg)
    slots, coords, mask = vis
    if entries == "none_live":
        sub = (slots, coords, torch.zeros_like(mask))
    else:
        full, _ = ttb.integrate_blocks(
            m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone()),
            cfg.camera, cfg.tsdf, cfg.blockmap, T, raw, vis)
        per_row = (full.weight != m.weight).flatten(1).sum(1)
        per_entry = torch.where(mask, per_row[slots.clamp(min=0).long()], 0)
        pick = torch.argsort(per_entry, descending=True)[:5 if entries == "five" else 1]
        sub = tuple(v[pick].contiguous() for v in vis)
    k, p, nk, np_, counts = kernel_and_plain(m, cfg, T, raw, sub)
    assert counts == (1, 1)
    assert nk == np_ == {"five": 5, "one": 1, "none_live": 0}[entries]
    updated = int((p.weight != m.weight).sum())
    assert (updated == 0) if entries == "none_live" else (updated > 100)
    assert torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32", "bfloat16"])
def test_generic_kernel_matches_plain(mapped4, dtype):
    """Blocks of 4^3 go through the per-voxel kernel: launched, not
    counted as a column launch, and bit-equal to the plain version."""
    m, T, raw, vis, _ = mapped4
    cfg = small_cfg(dtype, block_size=4)
    m = as_pool(m, cfg)
    k, p, nk, np_, counts = kernel_and_plain(m, cfg, T, raw, vis)
    assert counts == (1, 0)
    assert nk == np_ > 100
    assert int((p.weight != m.weight).sum()) > 1000
    assert torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_in_kernel_pose_inverse_matches_plain(mapped, dtype):
    """A pose turned 25 degrees about a skew axis and shifted: the
    kernel's own inverse of T_wc gives the pool that the plain version
    gets through se3_inverse."""
    m, T, raw, _, _ = mapped
    cfg = small_cfg(dtype)
    m = as_pool(m, cfg)
    axis = torch.tensor([0.3, -0.8, 0.52], dtype=torch.float64)
    axis = axis / axis.norm()
    K = torch.tensor([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]],
                     dtype=torch.float64)
    a = math.radians(25.0)
    dT = torch.eye(4, dtype=torch.float64)
    dT[:3, :3] = torch.eye(3, dtype=torch.float64) + math.sin(a) * K + (1 - math.cos(a)) * (K @ K)
    dT[:3, 3] = torch.tensor([0.07, -0.05, 0.11], dtype=torch.float64)
    T2 = (T.double().cpu() @ dT).float().to(T.device)
    vis = ttb.visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T2)
    k, p, nk, np_, counts = kernel_and_plain(m, cfg, T2, raw, vis)
    assert counts == (1, 1)
    assert nk == np_ > 20
    assert int((p.weight != m.weight).sum()) > 100
    assert torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_kernel_matches_plain_under_negative_fy(mapped, dtype):
    """The ICL convention fy < 0 (the kernel projects with the signed fy
    and gates on |fy|): the map, with the 4th frame rendered through the
    camera with fy negated, fused by the kernel bit-equal to the plain
    version."""
    m, T, _, _, _ = mapped
    cfg = small_cfg(dtype)
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, fy=-cfg.camera.fy))
    m = as_pool(m, cfg)
    raw = depth_to_meters(SyntheticScene().render_depth_mm(cfg.camera, T))
    vis = ttb.visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T, depth=raw)
    k, p, nk, np_, counts = kernel_and_plain(m, cfg, T, raw, vis)
    assert counts == (1, 1)
    assert nk == np_ > 100
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
@pytest.mark.parametrize("change", [
    dict(view_frustum_min=0.0), dict(view_frustum_max=1e7), dict(trunc_dist=1e-9)])
def test_kernel_refuses_constants_outside_its_range(mapped, change):
    """The kernel's division is exact for constants between 1e-6 and 1e6;
    the entry point launches nothing for others."""
    m, T, raw, vis, _ = mapped
    cfg = small_cfg()
    before = integrate_blocks_cuda.launches
    with pytest.raises(ValueError, match="1e-6"):
        integrate_blocks_cuda(m, cfg.camera, dataclasses.replace(cfg.tsdf, **change),
                              cfg.blockmap, T, raw, vis)
    assert integrate_blocks_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("negative_divisor", [False, True])
def test_kernel_division_is_correctly_rounded(mapped, negative_divisor):
    """The kernel's divide() (the division operator's fast path without
    its range check, see csrc/integrate.cu) against PyTorch's division on
    16 M pairs over the range the kernel uses it on: divisors of
    magnitude 1e-6..1e6, dividends zero or of magnitude 1e-20..1e30, and
    the weights' small integers."""
    fn = load_library("integrate").tf_divide
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 1 << 24
    gen = torch.Generator(device="cuda").manual_seed(7)

    def log_uniform(lo, hi):
        e = torch.rand(n, device="cuda", generator=gen) * (math.log(hi) - math.log(lo)) + math.log(lo)
        return torch.exp(e)

    a = log_uniform(1e-20, 1e30)
    a = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.5, a, -a)
    if not negative_divisor:  # 0 / -b is -0; the kernel divides zero only by b > 0
        a[::1001] = 0.0
    b = log_uniform(1e-6, 1e6)
    third = n // 3
    a[:third] = log_uniform(1e-3, 1e2)[:third]       # near the divisors
    b[:third] = log_uniform(1e-2, 3.0)[:third]       # depths
    b[third:2 * third] = torch.randint(1, 102, (third,), device="cuda", generator=gen).float()
    if negative_divisor:
        b = -b
    out = torch.empty_like(a)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    want = a / b
    assert torch.isfinite(want).all()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


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
    """A pipeline step (kernel path) issues no synchronizing operation, as
    far as PyTorch's sync debug mode detects: ICP returns its Gram matrix
    and no longer takes its eigenvalues."""
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
    assert len(syncs) == 0, syncs


@pytest.mark.cuda
def test_onehot_step_syncs_the_host_once(mapped):
    """ICP's onehot gather mode adds no host sync to the step: the band
    gather has no data-dependent shape."""
    _, _, _, _, (pipe, state, frame) = mapped
    pipe = BlockPipeline(dataclasses.replace(pipe.cfg, icp=dataclasses.replace(
        pipe.cfg.icp, gather_mode="onehot")), pipe.device)
    (_, aux), syncs = count_syncs(lambda: pipe.step(state, frame))
    assert len(syncs) == 0, syncs
    assert bool(aux.ok)


@pytest.mark.cuda
def test_banded_gather_on_the_card_matches_the_cpu():
    """The band gather on the card equals the CPU's for the same inputs,
    off-map and int32-extreme indices among them: values and in_band to
    the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from topfusion_tpu_torch.ops.gather_mm import banded_projective_gather

    g = torch.Generator().manual_seed(5)
    model = torch.randn(480, 640, 6, generator=g)
    v = (torch.arange(240)[:, None] * 2 + torch.randint(-40, 40, (240, 320), generator=g))
    u = torch.randint(-8, 648, (240, 320), generator=g)
    u[::7, ::5] = -2**31
    v[::11, ::3] = 2**31 - 1
    u, v = u.to(torch.int32), v.to(torch.int32)
    out_c, ok_c = banded_projective_gather(model, u, v, v_margin=32)
    out_g, ok_g = banded_projective_gather(model.cuda(), u.cuda(), v.cuda(), v_margin=32)
    assert ok_c.any() and not ok_c.all()
    assert torch.equal(ok_g.cpu(), ok_c) and torch.equal(out_g.cpu(), out_c)


# ----------------------------------------------------------------- display, color
@pytest.fixture(scope="module")
def colored():
    """A color map after 4 RGB-D frames on the card (kernel integrate):
    (pipeline, state, next depth frame, next rgb frame)."""
    if not torch.cuda.is_available():
        pytest.skip("the display and color paths of this file run on an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = small_cfg("int16", max_weight=100.0)
    cfg = dataclasses.replace(
        cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=True),
        blockmap=dataclasses.replace(cfg.blockmap, use_pallas_integrate=None))
    scene = SyntheticScene()
    poses = [torch.as_tensor(T, device=dev)
             for T in orbit_trajectory(5, max_angle_deg=4.0, max_shift=0.04, seed=3)]
    depths = [scene.render_depth_mm(cfg.camera, T) for T in poses]
    rgbs = [scene.render_rgb(cfg.camera, T) for T in poses]
    pipe = BlockPipeline(cfg, dev)
    state = pipe.init()
    for d, c in zip(depths[:4], rgbs[:4]):
        state, aux = pipe.step_rgb(state, d, c)
        assert bool(aux.ok)
    return pipe, state, depths[4], rgbs[4]


def forbid_syncs(fn):
    """Run ``fn`` with PyTorch raising on every synchronizing call."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["render", "render_view", "render_normals",
                                  "render_confidence", "render_color"])
def test_renders_make_no_host_sync(colored, mode):
    pipe, state, _, _ = colored
    if mode == "render_view":
        V = state.T_wc.clone()
        V[0, 3] += 0.05
        img = forbid_syncs(lambda: pipe.render(state, V))
    else:
        img = forbid_syncs(lambda: getattr(pipe, mode)(state))
    assert img.dtype == torch.uint8 and img.shape == (64, 80, 3) and img.is_cuda
    assert int((img.sum(-1) > 0).sum()) > 1000


@pytest.mark.cuda
def test_extract_pointcloud_makes_no_host_sync(colored):
    pipe, state, _, _ = colored
    pc = forbid_syncs(lambda: extract_pointcloud_blocks(
        state.block_map(), pipe.cfg.tsdf, pipe.cfg.blockmap, max_points=1 << 16))
    assert 1000 < int(pc.count) == int(pc.valid.sum()) <= 1 << 16


@pytest.mark.cuda
def test_step_rgb_syncs_the_host_once(colored):
    """Color fusion adds no sync: the step makes none."""
    pipe, state, depth, rgb = colored
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            new, aux = pipe.step_rgb(state, depth, rgb)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in rec
             if str(w.message).startswith("called a synchronizing")]
    assert len(syncs) == 0, syncs
    assert bool(aux.ok) and int((new.color != state.color).sum()) > 1000


@pytest.mark.cuda
def test_cpu_and_card_displays_agree(colored):
    """The same state rendered on the CPU and on the card: ``hit`` equal
    and depth within 1e-5 m on 99.5% of the pixels, images within one
    grey level on 99% (the tolerances the CPU tests hold against the JAX
    package; every operation of the march rounds once on both devices,
    only ``pow`` may differ in the last bit), and the same point cloud."""
    pipe, state, _, _ = colored
    cpu_pipe = BlockPipeline(pipe.cfg, device="cpu")
    cpu_state = block_state_from_numpy(block_state_to_numpy(state), device="cpu")
    a = pipe._free_view_raycast(state, state.T_wc)
    b = cpu_pipe._free_view_raycast(cpu_state, cpu_state.T_wc)
    assert int(b.hit.sum()) > 2000
    assert float((a.hit.cpu() == b.hit).float().mean()) >= 0.995
    assert float(((a.depth.cpu() - b.depth).abs() <= 1e-5).float().mean()) >= 0.995
    for mode in ("render", "render_normals", "render_confidence", "render_color"):
        x = getattr(pipe, mode)(state).cpu().to(torch.int32)
        y = getattr(cpu_pipe, mode)(cpu_state).to(torch.int32)
        assert float(((x - y).abs().amax(-1) <= 1).float().mean()) >= 0.99, mode
    pa = extract_pointcloud_blocks(state.block_map(), pipe.cfg.tsdf, pipe.cfg.blockmap, 1 << 16)
    pb = extract_pointcloud_blocks(cpu_state.block_map(), pipe.cfg.tsdf, pipe.cfg.blockmap, 1 << 16)
    assert int(pa.count) == int(pb.count)
    assert torch.equal(pa.valid.cpu(), pb.valid)
    assert float((pa.points.cpu() - pb.points).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_depth_only_step_is_untouched_by_the_color_pass(mapped):
    """Without rgb the step runs the device operations it ran before
    color was ported: ``step(state, depth)`` and ``step_rgb`` on a map
    without a color pool give the same state."""
    _, _, _, _, (pipe, state, frame) = mapped
    rgb = torch.zeros((64, 80, 3), dtype=torch.uint8, device=frame.device)
    a, _ = pipe.step(state, frame)
    b, _ = pipe.step_rgb(state, frame, rgb)
    assert torch.equal(a.tsdf, b.tsdf) and torch.equal(a.T_wc, b.T_wc)
    assert a.color.shape == b.color.shape == (1, 1, 1, 1, 3)


# ----------------------------------------------------------------- dense volume
def count_syncs(fn):
    """(result, messages of the synchronizing calls PyTorch detected)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in rec
                 if str(w.message).startswith("called a synchronizing")]


@pytest.fixture(scope="module")
def dense():
    """The 96^3 dense volume with color after 4 RGB-D frames on the card,
    guided raycast model maps: (pipeline, state, next depth, next rgb)."""
    if not torch.cuda.is_available():
        pytest.skip("the dense-volume paths of this file run on an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = small_cfg(max_weight=100.0)
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=True))
    scene = SyntheticScene()
    poses = [torch.as_tensor(T, device=dev)
             for T in orbit_trajectory(5, max_angle_deg=4.0, max_shift=0.04, seed=3)]
    depths = [scene.render_depth_mm(cfg.camera, T) for T in poses]
    rgbs = [scene.render_rgb(cfg.camera, T) for T in poses]
    pipe = DensePipeline(cfg, dev)
    state = pipe.init()
    for d, c in zip(depths[:4], rgbs[:4]):
        state, aux = pipe.step_rgb(state, d, c)
        assert bool(aux.ok)
    return pipe, state, depths[4], rgbs[4]


@pytest.mark.cuda
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "full"])
def test_dense_step_syncs_the_host_once(dense, guided):
    """A dense step, color fusion and either raycast branch included,
    issues no synchronizing operation."""
    pipe, state, depth, rgb = dense
    pipe = DensePipeline(dataclasses.replace(pipe.cfg, raycast=dataclasses.replace(
        pipe.cfg.raycast, guided=guided)), pipe.device)
    (new, aux), syncs = count_syncs(lambda: pipe.step_rgb(state, depth, rgb))
    assert len(syncs) == 0, syncs
    assert bool(aux.ok) and int((new.weight != state.weight).sum()) > 1000
    assert int((new.color != state.color).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["render", "render_color"])
def test_dense_renders_make_no_host_sync(dense, mode):
    pipe, state, _, _ = dense
    img = forbid_syncs(lambda: getattr(pipe, mode)(state))
    assert img.dtype == torch.uint8 and img.shape == (64, 80, 3) and img.is_cuda
    assert int((img.sum(-1) > 0).sum()) > 1000


@pytest.mark.cuda
def test_extract_pointcloud_dense_makes_no_host_sync(dense):
    pipe, state, _, _ = dense
    pc = forbid_syncs(lambda: extract_pointcloud_dense(
        state.volume(), pipe.cfg.tsdf, pipe.cfg.dense, max_points=1 << 16))
    assert 1000 < int(pc.count) == int(pc.valid.sum()) <= 1 << 16


@pytest.mark.cuda
def test_cpu_and_card_dense_agree(dense):
    """The same state and frame on the CPU and on the card.  integrate
    (depth and color): the pools equal to the bit (every operation rounds
    once on both devices).  raycast, full and guided: ``hit`` equal and
    depth within 1e-5 m on 99.5% of the pixels; ``render`` within one grey
    level on 99% (``pow`` may differ in the last bit); the same point
    cloud."""
    pipe, state, depth, rgb = dense
    cfg = pipe.cfg
    cpu_pipe = DensePipeline(cfg, device="cpu")
    cpu_state = dense_state_from_numpy(dense_state_to_numpy(state), device="cpu")
    raw = depth_to_meters(depth)
    T = state.T_wc
    a = td.integrate_dense(state.volume(), cfg.camera, cfg.tsdf, cfg.dense, T, raw)
    b = td.integrate_dense(cpu_state.volume(), cfg.camera, cfg.tsdf, cfg.dense, T.cpu(), raw.cpu())
    assert int((b.weight != cpu_state.weight).sum()) > 1000
    assert torch.equal(a.tsdf.cpu(), b.tsdf) and torch.equal(a.weight.cpu(), b.weight)
    ca = td.integrate_color_dense(state.color, a, cfg.camera, cfg.tsdf, cfg.dense, T, raw, rgb)
    cb = td.integrate_color_dense(cpu_state.color, b, cfg.camera, cfg.tsdf, cfg.dense,
                                  T.cpu(), raw.cpu(), rgb.cpu())
    assert torch.equal(ca.cpu(), cb)
    for kw in ({}, dict(expected_depth=raw, depth_margin=0.22, max_steps=24)):
        ra = td.raycast_dense(a, cfg.camera, cfg.tsdf, cfg.dense, cfg.raycast, T, **kw)
        kw_cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        rb = td.raycast_dense(b, cfg.camera, cfg.tsdf, cfg.dense, cfg.raycast, T.cpu(), **kw_cpu)
        assert int(rb.hit.sum()) > 2000
        assert float((ra.hit.cpu() == rb.hit).float().mean()) >= 0.995
        assert float(((ra.depth.cpu() - rb.depth).abs() <= 1e-5).float().mean()) >= 0.995
    for mode in ("render", "render_color"):
        x = getattr(pipe, mode)(state).cpu().to(torch.int32)
        y = getattr(cpu_pipe, mode)(cpu_state).to(torch.int32)
        assert float(((x - y).abs().amax(-1) <= 1).float().mean()) >= 0.99, mode
    pa = extract_pointcloud_dense(state.volume(), cfg.tsdf, cfg.dense, 1 << 16)
    pb = extract_pointcloud_dense(cpu_state.volume(), cfg.tsdf, cfg.dense, 1 << 16)
    assert int(pa.count) == int(pb.count) > 1000
    assert torch.equal(pa.valid.cpu(), pb.valid)
    assert float((pa.points.cpu() - pb.points).abs().max()) <= 1e-6


# ----------------------------------------------------------------- block swap
def swap_inputs(m):
    """Every third live slot, -1 padding and a slot that is not live."""
    nb = int(m.num_blocks)
    slots = torch.full((256,), -1, dtype=torch.int32)
    pick = torch.arange(0, nb, 3, dtype=torch.int32)[:200]
    slots[: len(pick)] = pick
    slots[-1] = nb + 1
    return slots


@pytest.mark.cuda
def test_swap_primitives_make_no_host_sync(colored):
    pipe, state, _, _ = colored
    m = state.block_map()
    bm = pipe.cfg.blockmap
    slots = swap_inputs(m).to(m.tsdf.device)
    ex = forbid_syncs(lambda: tsw.extract_blocks(m, slots))
    m2, remap = forbid_syncs(lambda: tsw.evict_blocks(m, slots, bm))
    m3, ok = forbid_syncs(lambda: tsw.insert_blocks(m2, ex, bm, 100.0))
    assert int(ex.valid.sum()) == 200 == int(ok.sum())
    assert int(m2.num_blocks) == int(m.num_blocks) - 200 and int(m3.num_blocks) == int(m.num_blocks)
    assert int((remap < 0).sum()) >= 200


@pytest.mark.cuda
def test_cpu_and_card_swap_agree(colored):
    """extract, evict and insert on the card and on the CPU from the same
    int16 color map: every field equal (integers, and float arithmetic
    that rounds once per operation on both)."""
    pipe, state, _, _ = colored
    bm = pipe.cfg.blockmap
    m = state.block_map()
    cm = block_state_from_numpy(block_state_to_numpy(state), device="cpu").block_map()
    slots = swap_inputs(m)
    ex, cex = tsw.extract_blocks(m, slots.to(m.tsdf.device)), tsw.extract_blocks(cm, slots)
    (m2, remap), (cm2, cremap) = (tsw.evict_blocks(m, slots.to(m.tsdf.device), bm),
                                  tsw.evict_blocks(cm, slots, bm))
    (m3, ok), (cm3, cok) = tsw.insert_blocks(m2, ex, bm, 100.0), tsw.insert_blocks(cm2, cex, bm, 100.0)
    # Once more: now a merge with what is there.
    (m4, _), (cm4, _) = tsw.insert_blocks(m3, ex, bm, 100.0), tsw.insert_blocks(cm3, cex, bm, 100.0)
    for got, want in ((ex, cex), (m2, cm2), (m3, cm3), (m4, cm4), ((remap, ok), (cremap, cok))):
        for name, g, w in zip(getattr(type(want), "_fields", ("remap", "ok")), got, want):
            assert torch.equal(g.cpu(), w), name
    assert not torch.equal(m4.weight, m3.weight)


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


# ----------------------------------------------------------------- SLAM
def slam_cfg(out_of_core=False, capacity=1 << 13):
    """tests/test_slam.make_cfg (80x64, keyframes every 3 frames, a
    16-keyframe graph) with the integrate kernel; optionally a capped pool
    behind the host cache."""
    return PipelineConfig(
        camera=CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0),
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(6, 4, 3)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(capacity=capacity, max_new_blocks_per_frame=2048,
                                max_visible_blocks=min(capacity, 1 << 12), alloc_pixel_stride=1,
                                out_of_core=out_of_core),
        raycast=RaycastConfig(max_steps=160),
        posegraph=PoseGraphConfig(max_keyframes=16, max_edges=64, keyframe_every=3,
                                  loop_candidate_window=2, loop_max_dist=0.3, gn_iters=5),
    )


def out_and_back(n):
    """tests/test_slam.out_and_back: out and back along x with a yaw."""
    from topfusion_tpu_torch.geometry.se3 import se3_exp

    poses = []
    for i in range(n):
        s = math.sin(math.pi * i / (n - 1))
        poses.append(se3_exp(torch.tensor([0, 0.08 * s, 0, 0.10 * s, 0.02 * s, 0])))
    return poses


def slam_frames(cfg, n, device):
    scene = SyntheticScene()
    return torch.stack([scene.render_depth_mm(cfg.camera, T.to(device)) for T in out_and_back(n)])


@pytest.mark.cuda
def test_slam_chunk_syncs_at_most_n_plus_2():
    """A chunk of frames (on the card already) syncs the host once,
    whatever its length: the one fetch (the steps make none, and loop
    verification's eigenvalues come from the eig6 kernel).  The warm-up
    captures the chunk's graphs first, as the app's does: a capture
    synchronizes."""
    from topfusion_tpu_torch.models.slam import SlamSystem

    if not torch.cuda.is_available():
        pytest.skip("the SLAM system's card path runs on an NVIDIA GPU")
    cfg = slam_cfg()
    frames = slam_frames(cfg, 15, "cuda")
    slam = SlamSystem(cfg)
    ke = cfg.posegraph.keyframe_every
    slam.warmup(ke)
    counts = []
    for c0 in range(0, 15, ke):
        infos, syncs = count_syncs(lambda: slam.process_chunk(frames[c0:c0 + ke]))
        assert all(i["ok"] for i in infos)
        if not any(i["loop"] for i in infos):   # a closure adds the solve's fetch
            counts.append(len(syncs))
            assert len(syncs) == 1, syncs
    assert counts and slam.loops_closed >= 1


def _drift_graph(device, k_cap=16, e_cap=64):
    """tests/test_posegraph.test_optimize_corrects_drift's graph: six
    keyframes drifting in y, true odometry edges and one loop edge 0 -> 5."""
    from topfusion_tpu_torch.geometry.se3 import se3_exp, se3_inverse
    from topfusion_tpu_torch.models import posegraph as pgm

    cfg = PoseGraphConfig(max_keyframes=k_cap, max_edges=e_cap, gn_iters=8)
    cam_l = slam_cfg().camera.at_level(1)
    pg = pgm.make_pose_graph(cfg, cam_l, device)
    p = torch.zeros((cam_l.height, cam_l.width, 3), device=device)
    true = [se3_exp(torch.tensor([0, 0, 0, 0.05 * i, 0, 0])).to(device) for i in range(6)]
    drift = [se3_exp(torch.tensor([0, 0, 0, 0.05 * i, 0.01 * i, 0])).to(device) for i in range(6)]
    for i in range(6):
        pg = pgm.add_keyframe(pg, drift[i], p, p, i, True)
    eT = pg.edge_T.clone()
    for e in range(5):
        eT[e] = se3_inverse(true[e]) @ true[e + 1]
    eT[5] = se3_inverse(true[0]) @ true[5]
    ei, ej, loop = pg.edge_i.clone(), pg.edge_j.clone(), pg.edge_is_loop.clone()
    ei[5], ej[5], loop[5] = 0, 5, True
    pg = pg._replace(edge_T=eT, edge_i=ei, edge_j=ej, edge_is_loop=loop,
                     num_edges=torch.full((), 6, dtype=torch.int32, device=device))
    return pg, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("k_cap", [16, 256])
def test_optimize_pcg_is_bit_reproducible(k_cap):
    """Two PCG solves of one graph on the card give the same poses to the
    bit (deterministic segment sums), also at the default 256 x 1024
    capacities; and they agree with the CPU's within 1e-5."""
    from topfusion_tpu_torch.models.posegraph import optimize_pcg

    if not torch.cuda.is_available():
        pytest.skip("the SLAM system's card path runs on an NVIDIA GPU")
    pg, cfg = _drift_graph("cuda", k_cap, 4 * k_cap)
    a, chi_a = optimize_pcg(pg, cfg)
    b, chi_b = optimize_pcg(pg, cfg)
    assert torch.equal(a.kf_poses, b.kf_poses) and torch.equal(chi_a, chi_b)
    cpu_pg, _ = _drift_graph("cpu", k_cap, 4 * k_cap)
    c, _ = optimize_pcg(cpu_pg, cfg)
    assert float((a.kf_poses.cpu() - c.kf_poses).abs().max()) < 1e-5


def _carry(src, dst):
    """dst (a port SlamSystem) in the state of src, host cache included."""
    from topfusion_tpu_torch.convert import slam_state_from_numpy, slam_state_to_numpy

    slam_state_from_numpy(slam_state_to_numpy(src), dst)
    if src.swap is not None:
        dst.swap.store = {k: tuple(None if a is None else a.clone() for a in v)
                          for k, v in src.swap.store.items()}
        dst.swap.last_seen = src.swap.last_seen.copy()
        dst.swap._frame = src.swap._frame


def corridor_slam(device):
    """tests/test_swap.py::test_swap_store_survives_reintegration: the
    corridor 15 frames out (pitched camera, 6 cm steps) and back, a pool of
    2048 blocks behind the host cache, keyframes every 3 frames, any loop
    correction rebuilding the map.  (config, frames [29, H, W] u16)."""
    from topfusion_tpu_torch.config import tiny_test_config
    from topfusion_tpu_torch.geometry.se3 import se3_exp
    from topfusion_tpu_torch.io.synthetic import corridor_scene, sweep_trajectory

    base = tiny_test_config()
    cfg = dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
        blockmap=dataclasses.replace(base.blockmap, capacity=1 << 11,
                                     max_visible_blocks=1 << 11, out_of_core=True),
        posegraph=dataclasses.replace(base.posegraph, min_map_correction=0.0,
                                      keyframe_every=3, loop_max_dist=0.5),
    )
    pitch = se3_exp(torch.tensor([0.35, 0, 0, 0, 0, 0])).numpy()
    scene = corridor_scene(length_m=6.5, box_every=0.35)
    fwd = [T @ pitch for T in sweep_trajectory(15, step_m=0.06)]
    gt = fwd + fwd[::-1][1:]
    return cfg, torch.stack([scene.render_depth_mm(cfg.camera, torch.as_tensor(T, device=device))
                             for T in gt])


@pytest.mark.cuda
def test_out_of_core_slam_card_matches_cpu():
    """SlamSystem with out_of_core=True on the corridor: each frame on the
    card, from the CPU run's state and host cache before it, makes the CPU
    frame's decisions (ok, reset, blocks dropped, loop, rebuild, keyframes)
    with its pose within 0.25 mm and its blocks on the host within 1%.
    Frames are compared one at a time because this badly conditioned
    scene turns rounding into millimetres within a few frames
    (tests/test_torch_swap.py; a chunk of 3 frames was 0.15 mm apart)."""
    from topfusion_tpu_torch.models.slam import SlamSystem

    if not torch.cuda.is_available():
        pytest.skip("the SLAM system's card path runs on an NVIDIA GPU")
    cfg, frames = corridor_slam("cpu")
    cpu, card = SlamSystem(cfg, device="cpu"), SlamSystem(cfg)
    for f in frames:
        _carry(cpu, card)
        want, got = cpu.process_frame(f), card.process_frame(f)
        for key in ("ok", "reset", "dropped", "loop", "reintegrated"):
            assert got.get(key) == want.get(key), (want["frame"], key)
        assert abs(card.swap.n_host_blocks - cpu.swap.n_host_blocks) <= \
            0.01 * cpu.swap.n_host_blocks + 2, want["frame"]
        assert int(card.graph.num_kf) == int(cpu.graph.num_kf)
        assert (card.loops_closed, card.reintegrations) == (cpu.loops_closed, cpu.reintegrations)
        assert abs(card.odom_poses[-1] - cpu.odom_poses[-1]).max() < 2.5e-4, want["frame"]
    assert cpu.swap.n_host_blocks > 0


@pytest.mark.cuda
def test_detect_loop_card_matches_cpu():
    """tests/test_posegraph.py's revisit (keyframes walking out 15 cm and
    back): detect_loop on the card closes the same loops as on the CPU,
    with the measured transforms within 1e-5."""
    from topfusion_tpu_torch.geometry.se3 import se3_exp
    from topfusion_tpu_torch.models import posegraph as pgm
    from topfusion_tpu_torch.ops.normals import compute_points_normals

    if not torch.cuda.is_available():
        pytest.skip("the SLAM system's card path runs on an NVIDIA GPU")
    cfg = slam_cfg()
    pgc = PoseGraphConfig(max_keyframes=16, max_edges=64, loop_candidate_window=3,
                          loop_max_dist=0.5, gn_iters=5)
    cam_l = cfg.camera.at_level(1)
    scene = SyntheticScene()
    out = []
    for dev in ("cpu", "cuda"):
        pg = pgm.make_pose_graph(pgc, cam_l, dev)
        for i in range(8):
            x = 0.05 * i if i < 4 else 0.05 * (7 - i)
            T = se3_exp(torch.tensor([0, 0, 0, x, 0, 0])).to(dev)
            p, n = compute_points_normals(cam_l, scene.render_depth(cam_l, T))
            pg = pgm.add_keyframe(pg, T, p, n, i, True)
        out.append(pgm.detect_loop(pg, cam_l, pgc, ICPConfig()))
    (c, cf, ci), (g, gf, gi) = out
    assert bool(cf) and bool(gf)
    for name in ("edge_i", "edge_j", "edge_is_loop", "num_edges", "kf_loop_done"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    assert float((g.edge_T.cpu() - c.edge_T).abs().max()) < 1e-5
    assert int(gi.n_closed) == int(ci.n_closed)


# ----------------------------------------------------------------- sharded map
@pytest.mark.cuda
def test_sharded_world_of_one_is_block_pipeline_on_the_card():
    """A world of one NCCL shard on the card steps exactly as
    ``BlockPipeline`` with the integrate kernel (state, model maps and aux
    bit-identical over 4 frames, one kernel launch a frame for each), and
    a warm sharded step makes no host sync, as the single-device step:
    the NCCL collectives add none."""
    if not torch.cuda.is_available():
        pytest.skip("the sharded card path runs on an NVIDIA GPU")
    from torch_sharded_world import card_world_of_one
    from topfusion_tpu_torch.parallel import spawn_world

    cfg = small_cfg()
    cfg = dataclasses.replace(cfg, blockmap=dataclasses.replace(cfg.blockmap, use_pallas_integrate=None))
    (out,) = spawn_world(card_world_of_one, 1, "nccl", "cuda", args=(cfg, 4), timeout_s=300)
    assert out["same"] == [True] * 4
    assert out["launches"] == 8
    assert out["ok"] and len(out["syncs"]) == 0, out["syncs"]


@pytest.mark.cuda
def test_gloo_world_on_the_card_reduces_card_tensors():
    """Two gloo shards sharing the card: every collective of the map axis
    takes the shards' CUDA tensors as they are and gives the right value
    back on the card."""
    if not torch.cuda.is_available():
        pytest.skip("the sharded card path runs on an NVIDIA GPU")
    from torch_sharded_world import card_collectives
    from topfusion_tpu_torch.parallel import spawn_world

    for out in spawn_world(card_collectives, 2, "gloo", "cuda", timeout_s=300):
        assert out["devices"] == ["cuda"] * 6
        for name in ("psum", "pmin", "gather", "gather_bool", "gram"):
            assert out[name], name
        assert out["calls"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_kernel_matches_plain_on_a_shard_local_pool(dtype):
    """The integrate kernel on one shard's local pool (shard 1 of 4: its
    own blocks, allocated with the ownership filter over three frames) is
    bit-equal to the plain version, as on a whole map."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA integrate kernel runs only on an NVIDIA GPU")
    from topfusion_tpu_torch.parallel.block_sharded import _shard_cfg

    dev = torch.device("cuda")
    cfg = _shard_cfg(small_cfg(pool_dtype=dtype), 4)
    bm, shard = cfg.blockmap, (1, 4)
    poses = orbit_trajectory(4, max_angle_deg=4.0, max_shift=0.04, seed=3)
    scene = SyntheticScene()
    m = tbm.make_block_map(bm, device=dev)
    for T in poses:
        T = torch.as_tensor(T, device=dev)
        raw = depth_to_meters(scene.render_depth_mm(cfg.camera, T))
        m, _ = ttb.allocate_from_depth(m, cfg.camera, cfg.tsdf, bm, T, raw, shard=shard)
        vis = ttb.visible_blocks(m, cfg.camera, cfg.tsdf, bm, T, depth=raw)
        k, p, nk, np_, counts = kernel_and_plain(m, cfg, T, raw, vis)
        assert torch.equal(k.tsdf, p.tsdf) and torch.equal(k.weight, p.weight)
        assert nk == np_ > 0 and counts == (1, 1)
        m = p
    owned = tbm._bucket_owner(m.block_coords[: int(m.num_blocks)], bm.capacity, shard)[1]
    assert bool(owned.all())



# ------------------------------------------------------- the sharded SLAM system
@pytest.mark.cuda
def test_distributed_solve_on_one_shard_is_optimize_pcg_on_the_card():
    """``optimize_distributed`` on a world of one NCCL shard is
    ``optimize_pcg``, bit for bit, on tests/test_parallel.py's drifted
    graph; it issues gn_iters x (cg_iters + 3) sums and syncs the host
    nowhere."""
    if not torch.cuda.is_available():
        pytest.skip("the sharded card path runs on an NVIDIA GPU")
    from torch_sharded_world import card_dist_ba_world_of_one
    from topfusion_tpu_torch.parallel import spawn_world

    (out,) = spawn_world(card_dist_ba_world_of_one, 1, "nccl", "cuda", timeout_s=300)
    assert out["same"]
    assert out["calls"] == out["gn"] * (out["cg"] + 3)
    assert out["bytes"] == out["gn"] * ((out["cg"] + 2) * out["k"] * 24 + out["k"] * 144)
    assert out["syncs"] == [], out["syncs"]


@pytest.mark.cuda
def test_sharded_slam_world_of_one_is_slam_system_at_vga():
    """Six VGA frames of the app's operating point in chunks of 3 through
    a ``ShardedSlamSystem`` on a world of one NCCL shard and through
    ``SlamSystem``: odometry, graph and map bit-identical; a chunk syncs
    the host at most 3 times (SlamSystem's 2, and no more: the
    decisions' broadcast adds none)."""
    if not torch.cuda.is_available():
        pytest.skip("the sharded card path runs on an NVIDIA GPU")
    import argparse

    import numpy as np

    from torch_sharded_world import card_slam_world_of_one
    from topfusion_tpu_torch.apps.run_fusion import _app_config
    from topfusion_tpu_torch.parallel import spawn_world

    cfg = _app_config(argparse.Namespace(config=None, overrides=[], rgb=False))
    cam = CameraConfig(width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    cfg = dataclasses.replace(cfg, camera=cam)
    poses = orbit_trajectory(6, max_angle_deg=3.0, max_shift=0.03, seed=1)
    scene = SyntheticScene()
    frames = np.stack([scene.render_depth_mm(cam, torch.as_tensor(T)).numpy() for T in poses])
    (out,) = spawn_world(card_slam_world_of_one, 1, "nccl", "cuda", args=(cfg, frames, 3),
                         timeout_s=600)
    assert out["odom"] and out["graph"] and out["state"] and out["ok"]
    assert all(s <= 3 for s in out["syncs"]), out["syncs"]


# ----------------------------------------------------------- the stream pipeline
@pytest.fixture(scope="module")
def stream_card():
    """A ``2 x 1`` stream world of two gloo processes sharing the card over
    the 8-frame test orbit at the 80x64 test config, and ``run_lockstep``
    over the same frames in this process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("the stream pipeline's card path runs on an NVIDIA GPU")
    from torch_sharded_world import card_stream_world, tensor_digest
    from topfusion_tpu_torch.config import tiny_test_config
    from topfusion_tpu_torch.parallel import spawn_world
    from topfusion_tpu_torch.parallel.stream_pipeline import run_lockstep

    cfg = tiny_test_config()
    poses = orbit_trajectory(8, max_angle_deg=3.0, max_shift=0.03, seed=11)
    scene = SyntheticScene()
    frames = [scene.render_depth_mm(cfg.camera, torch.as_tensor(T)).numpy() for T in poses]
    ranks = spawn_world(card_stream_world, 2, "gloo", "cuda", args=(cfg, frames), timeout_s=300)
    dev = torch.device("cuda")
    (s0, r0), (s1, r1), lposes = run_lockstep(
        cfg, [torch.from_numpy(f).to(dev) for f in frames], dev)
    lock = dict(stage0=tensor_digest(s0), reg0=tensor_digest(r0), stage1=tensor_digest(s1),
                reg1=tensor_digest(r1), poses=lposes.cpu().numpy())
    return dict(cfg=cfg, n=len(frames), ranks=ranks, lock=lock)


@pytest.mark.cuda
def test_stream_world_is_the_lockstep_on_the_card(stream_card):
    """Two gloo processes sharing the card step the stream pipeline
    exactly as its two stage functions in lockstep in one process: stage
    0's trajectory, state and register and stage 1's map, model maps and
    register, to the bit; stage 1 launches the integrate kernel once a
    step (the first on a list with nothing visible), stage 0 never."""
    s0, s1 = stream_card["ranks"]
    lock = stream_card["lock"]
    assert (s0["stage"], s1["stage"]) == (0, 1)
    np.testing.assert_array_equal(s0["poses"], lock["poses"])
    assert s0["digest"] == lock["stage0"] and s0["reg_digest"] == lock["reg0"]
    assert s1["digest"] == lock["stage1"] and s1["reg_digest"] == lock["reg1"]
    assert (s0["launches"], s1["launches"]) == (0, stream_card["n"])


@pytest.mark.cuda
def test_stream_step_syncs_per_stage(stream_card):
    """Host syncs of a warm stream step under gloo, as PyTorch's sync
    debug mode detects them in the calling thread: neither stage syncs
    (stage 0's ICP no longer takes eigenvalues).  gloo stages the card's tensors
    through the host in its own worker threads, where the debug mode
    only prints a warning to stderr."""
    s0, s1 = stream_card["ranks"]
    assert len(s0["syncs"]) == 0, s0["syncs"]
    assert len(s1["syncs"]) == 0, s1["syncs"]


@pytest.mark.cuda
def test_stream_link_bytes_per_step(stream_card):
    """One step moves the forward buffer (pose, depth, two flags) and the
    backward buffer (two 3-level model-map pyramids, their pose, a flag)
    over the link, as two broadcasts counted on both processes."""
    from topfusion_tpu_torch.parallel.stream_pipeline import link_bytes

    cfg = stream_card["cfg"]
    cam = cfg.camera
    pix = sum(cam.at_level(i).height * cam.at_level(i).width
              for i in range(cfg.preproc.pyramid_levels))
    fwd, bwd = (16 + cam.height * cam.width + 2) * 4, (6 * pix + 16 + 1) * 4
    assert link_bytes(cfg) == (fwd, bwd)
    for out in stream_card["ranks"]:
        assert out["link"] == (2, fwd + bwd)


def test_slam_cfg_mirrors_the_jax_test_config():
    """slam_cfg is tests/test_slam.make_cfg (this file cannot import that
    one)."""
    from tests.test_slam import make_cfg
    from topfusion_tpu_torch.convert import config_from_reference

    assert slam_cfg() == config_from_reference(make_cfg())


@pytest.mark.cuda
def test_png16_round_trip_through_native_decoder(tmp_path):
    """A VGA depth frame rendered on the card, written as a 16-bit PNG by
    ``io/png.py`` and read back through the repository's native decoder
    (the dataset path of the app's ``--sequence``)."""
    from topfusion_tpu_torch.io.datasets import _read_png
    from topfusion_tpu_torch.io.native_loader import decoder_name
    from topfusion_tpu_torch.io.png import write_png

    if not torch.cuda.is_available():
        pytest.skip("renders on the card")
    cam = CameraConfig()
    depth = SyntheticScene().render_depth_mm(cam, torch.eye(4, device="cuda")).cpu().numpy()
    path = str(tmp_path / "d.png")
    write_png(path, depth)
    assert decoder_name().startswith("native")
    got = _read_png(path)
    assert got.dtype == np.uint16 and got.shape == (480, 640)
    np.testing.assert_array_equal(got, depth)
    assert (depth > 0).mean() > 0.3


@pytest.mark.cuda
def test_view_tool_on_the_card(mapped, tmp_path):
    """``tools/view`` on a run directory of a map fused on the card
    (config.json, as the app writes it without pyyaml): the key script's
    final pose is ``move_pose`` over the keys, view.png is not constant."""
    import contextlib
    import io
    import json

    from topfusion_tpu_torch.geometry.viewpath import move_pose
    from topfusion_tpu_torch.io.datasets import _read_png
    from topfusion_tpu_torch.tools import view
    from topfusion_tpu_torch.utils.checkpoint import save_state
    from topfusion_tpu_torch.utils.config_io import save_config

    pipe, state, _ = mapped[4]
    run_dir = str(tmp_path)
    save_config(str(tmp_path / "config.json"), pipe.cfg)
    save_state(str(tmp_path / "state.npz"), state)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert view.main([run_dir, "--script", "wjsqo", "--step", "0.02"]) == 0
    lines = buf.getvalue().splitlines()
    T = state.T_wc.cpu().numpy()
    for k in "wjs":
        T = move_pose(T, k, step_m=0.02)
    final = json.loads(next(ln for ln in lines if ln.startswith("final pose "))[len("final pose "):])
    np.testing.assert_array_equal(np.asarray(final, np.float32), T)
    img = _read_png(str(tmp_path / "view.png"))
    assert img.shape == (64, 80, 3) and img.std() > 0
    assert sum("coverage" in ln for ln in lines) == 4


# ----------------------------------------------------------- the captured step
def captured_inputs(mapped):
    """The kernel-path pipeline at the small config, the state after 3
    frames of the orbit, and 4 frames on from there."""
    _, _, _, _, (pipe, state, _) = mapped
    pipe = BlockPipeline(dataclasses.replace(pipe.cfg, blockmap=dataclasses.replace(
        pipe.cfg.blockmap, use_pallas_integrate=None)), pipe.device)
    scene = SyntheticScene()
    poses = orbit_trajectory(7, max_angle_deg=4.0, max_shift=0.04, seed=3)[3:]
    frames = torch.stack([scene.render_depth_mm(pipe.cfg.camera, torch.as_tensor(T, device="cuda"))
                          for T in poses])
    return pipe, state, frames


@pytest.mark.cuda
def test_captured_step_replays_the_eager_step(mapped):
    """``CapturedStep`` replays the step, integrate kernel included, to the
    bit: every state field and every aux field equal to the eager steps'
    over 4 frames; one kernel launch counted per replay, and none for the
    capture, which launches nothing (the warm-up steps launch theirs)."""
    from topfusion_tpu_torch.models.captured import WARMUP_STEPS, CapturedStep

    pipe, state, frames = captured_inputs(mapped)
    built = integrate_blocks_cuda.launches
    runner = CapturedStep(pipe, state)
    assert integrate_blocks_cuda.launches - built == WARMUP_STEPS
    assert runner.graph is not None and runner.per_replay["integrate_blocks_cuda.launches"] == 1
    eager, auxes = state, []
    for f in frames:
        eager, aux = pipe.step(eager, f)
        auxes.append(aux)
    before = (integrate_blocks_cuda.launches, integrate_blocks_cuda.vector_launches)
    got = runner.run(frames)
    torch.cuda.synchronize()
    assert (integrate_blocks_cuda.launches - before[0],
            integrate_blocks_cuda.vector_launches - before[1]) == (4, 4)
    replayed = runner.state()
    for name, a in eager._asdict().items():
        b = getattr(replayed, name)
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert torch.equal(a, b), name
    for name in got._fields:
        assert torch.equal(torch.stack([getattr(a, name) for a in auxes]), getattr(got, name)), name
    assert bool(got.ok.all())


@pytest.mark.cuda
def test_captured_chunk_makes_no_host_sync(mapped):
    """A chunk of replays runs under sync debug mode "error": the frame
    copies, the replays and the aux copies never wait for the card."""
    from topfusion_tpu_torch.models.captured import CapturedStep

    pipe, state, frames = captured_inputs(mapped)
    runner = CapturedStep(pipe, state)
    aux = forbid_syncs(lambda: runner.run(frames))
    _, syncs = count_syncs(lambda: runner.run(frames))
    assert syncs == [] and bool(aux.ok.all())


@pytest.mark.cuda
def test_capture_of_a_syncing_step_raises(mapped):
    """A step that reads a value back cannot be captured: the runner
    raises, it does not run the step eagerly instead."""
    from topfusion_tpu_torch.models.captured import CapturedStep

    pipe, state, _ = captured_inputs(mapped)

    class Syncing:
        cfg = pipe.cfg

        def step(self, s, depth_mm):
            s, aux = pipe.step(s, depth_mm)
            return s._replace(frame=s.frame + int(aux.num_blocks > 0)), aux

    with pytest.raises(RuntimeError):
        CapturedStep(Syncing(), state)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bench_scenarios_on_the_card(mapped):
    """``tools/bench``'s three scenarios at the small config capture the
    step (the sharded one with its NCCL collectives on a world of one),
    track every frame, and the sweep drops no block.  The integrate
    kernel's count is one per step that ran: the eager bootstrap steps,
    the runner's warm-up steps, the warm-up chunk's and the timed replays
    (the capture counts none)."""
    from topfusion_tpu_torch.models.captured import WARMUP_STEPS
    from topfusion_tpu_torch.tools import bench

    pipe, _, _ = captured_inputs(mapped)
    cfg = pipe.cfg
    for name, fn, kw, bootstrap in (("orbit", bench.bench_orbit, dict(passes=1), 2),
                                    ("sweep", bench.bench_sweep, dict(n_frames=16), 1),
                                    ("sharded", bench.bench_sharded_orbit, dict(passes=1), 2)):
        detail = {}
        torch.cuda.synchronize()
        integrate_blocks_cuda.launches = 0
        res = fn(cfg, "cuda", detail=detail, **kw)
        torch.cuda.synchronize()
        assert res["value"] > 0, name
        assert bool(torch.cat([a.ok for a in detail["auxes"]]).all()), name
        assert integrate_blocks_cuda.launches == (
            bootstrap + WARMUP_STEPS + bench.CHUNK + detail["frames"]), name
        if name == "sweep":
            assert detail["blocks_dropped"] == 0
        if name == "sharded":
            assert detail["backend"] == "nccl"
        del detail
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- eig6
def eig6_inputs(n, seed=0):
    """``n`` seeded float32 6x6 symmetric matrices: graded PSD spectra
    (condition numbers 1 to 1e8, random scales), a tenth rank-deficient,
    a tenth zero, a tenth diagonal."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 6, 6)))
    lam = 10.0 ** (rng.uniform(-3, 6, (n, 1)) - rng.uniform(0, 8, (n, 1)) * np.linspace(0, 1, 6))
    k = n // 10
    lam[:k, 3:] = 0.0
    a = (q * lam[:, None, :]) @ q.transpose(0, 2, 1)
    a = (a + a.transpose(0, 2, 1)) / 2
    a[k:2 * k] = 0.0
    a[2 * k:3 * k] = np.eye(6)[None] * rng.uniform(0.0, 5.0, (k, 1, 6))
    return torch.from_numpy(a.astype(np.float32))


@pytest.mark.cuda
def test_eig6_kernel_is_bit_equal_to_its_twin():
    """The kernel on 10^4 seeded matrices: eigenvalues and ratios
    bit-equal to the plain twin run on the card (float64 with one IEEE
    rounding per operation on both), eigenvalues within 1e-12 x lambda_max
    of ``torch.linalg.eigvalsh`` in float64; one launch counted, no host
    sync."""
    from topfusion_tpu_torch.ops import icp
    from topfusion_tpu_torch.ops.cuda.eig6 import eigvals_cuda, obs_ratio_cuda

    if not torch.cuda.is_available():
        pytest.skip("the eig6 kernel runs only on an NVIDIA GPU")
    a = eig6_inputs(10_000).cuda()
    eigvals_cuda(a[:1])
    before = obs_ratio_cuda.launches
    ratio, eig = forbid_syncs(lambda: eigvals_cuda(a))
    torch.cuda.synchronize()
    assert obs_ratio_cuda.launches - before == 1
    twin = icp.jacobi_eigvals6(a)
    assert torch.equal(eig, twin)
    assert torch.equal(ratio, icp.ratio_from_eigvals(twin))
    assert torch.equal(obs_ratio_cuda(a), ratio) and torch.equal(icp.obs_ratio(a), ratio)
    ref = torch.linalg.eigvalsh(a.double())
    err = (eig - ref).abs().amax(-1) / ref.abs().amax(-1).clamp(min=1e-300)
    assert float(err.max()) <= 1e-12


@pytest.mark.cuda
def test_eig6_wrapper_refuses_what_the_kernel_does_not_take():
    from topfusion_tpu_torch.ops.cuda.eig6 import obs_ratio_cuda

    if not torch.cuda.is_available():
        pytest.skip("the eig6 kernel runs only on an NVIDIA GPU")
    with pytest.raises(ValueError, match="float32"):
        obs_ratio_cuda(torch.zeros((2, 6, 6), dtype=torch.float64, device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        obs_ratio_cuda(torch.zeros((2, 5, 5), device="cuda"))


# ----------------------------------------------------------------- captured SLAM
def rebuilding_slam_cfg():
    """slam_cfg with an 8-frame ring and every correction rebuilding."""
    cfg = slam_cfg()
    return dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, reint_ring=8, min_map_correction=0.0))


def slam_numpy(slam):
    from topfusion_tpu_torch.convert import slam_state_to_numpy

    return slam_state_to_numpy(slam)


def slam_differs(x, y):
    """The fields in which two ``slam_state_to_numpy`` values differ
    (empty: bit-identical)."""
    bad = []
    for part in ("state", "graph"):
        for name, v in x[part].items():
            w = y[part][name]
            pairs = zip(v, w) if isinstance(v, tuple) else [(v, w)]
            if not all(np.array_equal(p, q) for p, q in pairs):
                bad.append(f"{part}.{name}")
    for name in ("kf_depth_buf", "kf_odom_buf"):
        if not np.array_equal(x[name], y[name]):
            bad.append(name)
    if not all(np.array_equal(p, q) for p, q in zip(x["ring"], y["ring"])):
        bad.append("ring")
    for name in ("odom_poses", "kf_odom_poses"):
        if not np.array_equal(np.stack(x[name]), np.stack(y[name])):
            bad.append(name)
    for name in ("kf_for_frame", "frame_idx", "loops_closed", "reintegrations"):
        if x[name] != y[name]:
            bad.append(name)
    return bad


SLAM_DO_KF = (True, False, True, True, True)  # the chunks of 3 frames


@pytest.fixture(scope="module")
def captured_slam():
    """The 15-frame out-and-back in chunks of 3 through the captured
    system and the eager one (``_make_runner`` giving None), each warmed
    first: the
    first three chunks (frame0 0, 3, 6; do_kf True, False, True), then
    the rest (closures, solves, rebuilds).  Per system: the state after
    three chunks and at the end, infos, host syncs per chunk, integrate
    and eig6 launches."""
    from topfusion_tpu_torch.models.slam import SlamSystem
    from topfusion_tpu_torch.ops.cuda.eig6 import obs_ratio_cuda

    if not torch.cuda.is_available():
        pytest.skip("the SLAM system's card path runs on an NVIDIA GPU")
    cfg = rebuilding_slam_cfg()
    frames = slam_frames(cfg, 15, "cuda")
    runs = {}
    for capture in (True, False):
        slam = SlamSystem(cfg)
        if not capture:
            slam._make_runner = lambda: None
        slam.warmup(3)
        torch.cuda.synchronize()
        launches = (integrate_blocks_cuda.launches, obs_ratio_cuda.launches)
        r = dict(slam=slam, infos=[], syncs=[])
        for c, kf in enumerate(SLAM_DO_KF):
            got, syncs = count_syncs(lambda: slam.process_chunk(frames[3 * c:3 * c + 3], do_kf=kf))
            r["infos"] += got
            r["syncs"].append(len(syncs))
            if c == 2:
                r["three"] = slam_numpy(slam)
        torch.cuda.synchronize()
        r["launches"] = (integrate_blocks_cuda.launches - launches[0],
                         obs_ratio_cuda.launches - launches[1])
        r["end"] = slam_numpy(slam)
        runs[capture] = r
    return runs


@pytest.mark.cuda
def test_captured_chunks_are_the_eager_chunks(captured_slam):
    """Three chunks of different frame0 and do_kf replayed from one tail
    graph: bit-identical to the eager chunks (a value baked into the
    graph would part them), and the infos equal."""
    cap, eag = captured_slam[True], captured_slam[False]
    assert cap["slam"]._runner is not None and eag["slam"]._runner is None
    assert slam_differs(cap["three"], eag["three"]) == []
    assert cap["infos"][:9] == eag["infos"][:9]
    assert all(i["ok"] for i in cap["infos"])
    assert cap["three"]["graph"]["num_kf"] == 2  # the do_kf=False chunk added none


@pytest.mark.cuda
def test_captured_solve_and_rebuild_are_the_eager_ones(captured_slam):
    """The whole run, closures and rebuilds included: bit-identical, the
    same integrate and eig6 launches (counted per replay)."""
    cap, eag = captured_slam[True], captured_slam[False]
    assert cap["slam"].loops_closed >= 1 and cap["slam"].reintegrations >= 1
    assert slam_differs(cap["end"], eag["end"]) == []
    assert cap["infos"] == eag["infos"]
    assert cap["launches"] == eag["launches"] and cap["launches"][1] == len(SLAM_DO_KF)


@pytest.mark.cuda
def test_captured_chunk_syncs_once(captured_slam):
    """One host sync per chunk (the fetch); a closure adds the solve's
    fetch and, with a rebuild, the correction's."""
    cap = captured_slam[True]
    for c, syncs in enumerate(cap["syncs"]):
        chunk = cap["infos"][3 * c:3 * c + 3]
        want = 1 + (chunk[0]["loop"]) + bool(chunk[0].get("reintegrated"))
        assert syncs == want, (c, syncs, want)


@pytest.mark.cuda
def test_chunk_replays_make_no_host_sync(captured_slam):
    """The runner's chunk (the step replays, the copies, the tail replay)
    under sync debug mode "error"; the fetch is the caller's."""
    slam = captured_slam[True]["slam"]
    frames = slam_frames(slam.cfg, 15, "cuda")[:3]
    forbid_syncs(lambda: slam._runner.chunk(frames, None, slam.frame_idx, True))
    torch.cuda.synchronize()
