"""Port vs JAX package: surfel-splat model maps on a map the JAX pipeline
fused, and the packed z-buffer's min-dilate."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops import blockmap as jbm
from topfusion_tpu.ops import splat as jsplat
from topfusion_tpu.ops import tsdf_block as jtb
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.ops import blockmap as tbm
from topfusion_tpu_torch.ops import splat as tsplat

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=["float32", "int16"])
def fused(request):
    """JAX map after 4 frames of the test orbit (pool dtype per param),
    its pose and its full-scan visible set, as numpy."""
    cfg = make_cfg()
    cfg = dataclasses.replace(
        cfg, blockmap=dataclasses.replace(cfg.blockmap, pool_dtype=request.param))
    scene = SyntheticScene()
    poses = orbit_trajectory(8, max_angle_deg=4.0, max_shift=0.04, seed=3)
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    for T in poses[:4]:
        state, _ = pipe.step(state, scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
    m = state.block_map()
    T = np.asarray(state.T_wc)
    vis = tuple(np.asarray(v) for v in jtb.visible_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.asarray(T)))
    pool = {f: np.asarray(getattr(m, f)) for f in jbm.BlockMap._fields}
    return cfg, config_from_reference(cfg), pool, T, vis


@pytest.mark.parametrize("surfels,dilate", [(128, 1), (80, 1), (80, 0)])
def test_splat_matches_jax(fused, surfels, dilate):
    """The same surfels win on the CPU: hit mask, points, normals and
    confidence bit-equal, depth within 1e-6 m (the camera-frame z of the
    winner is computed by an einsum in the JAX package and by a
    left-to-right sum here, one ulp apart).  That is tighter than the
    port's bound of 99.9% equal hits and 1e-5 m, which allows a float32
    ulp to move a surfel across a pixel or depth-bin boundary."""
    jc, tc, pool, T, vis = fused
    mj = jbm.BlockMap(*[jnp.asarray(pool[f]) for f in jbm.BlockMap._fields])
    mt = tbm.BlockMap(*[t(pool[f]) for f in tbm.BlockMap._fields])
    rj = jsplat.splat_model_maps(mj, jc.camera, jc.tsdf, jc.blockmap, jnp.asarray(T),
                                 tuple(jnp.asarray(v) for v in vis),
                                 surfels_per_block=surfels, dilate_passes=dilate)
    rt = tsplat.splat_model_maps(mt, tc.camera, tc.tsdf, tc.blockmap, t(T),
                                 tuple(t(v) for v in vis),
                                 surfels_per_block=surfels, dilate_passes=dilate)
    assert np.asarray(rj.hit).mean() > 0.5
    for name in ("hit", "points", "normals", "confidence"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 7), (16, 20)])
def test_min_dilate_matches_jax(shape):
    rng = np.random.default_rng(0)
    sentinel = 2**31 - 1
    img = rng.integers(0, 1 << 20, size=shape).astype(np.int32)
    img[rng.uniform(size=shape) < 0.4] = sentinel
    np.testing.assert_array_equal(
        tsplat._min_dilate(t(img), sentinel).numpy(),
        np.asarray(jsplat._min_dilate(jnp.asarray(img), sentinel)))
