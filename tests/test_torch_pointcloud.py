"""Point-cloud extraction and PLY export of the port against the JAX
package, on the 8-frame fused map of tests/test_torch_raycast.py and on
the 4-frame dense volume of tests/test_torch_tsdf_dense.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raycast import fused
from tests.test_torch_tsdf_dense import fused as fused_dense
from topfusion_tpu.ops import pointcloud as jpc
from topfusion_tpu_torch.io.synthetic import SyntheticScene
from topfusion_tpu_torch.ops import pointcloud as tpc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clouds():
    f = fused()
    cfg, tcfg = f["cfg"], f["tcfg"]
    want = jax.jit(lambda m: jpc.extract_pointcloud_blocks(m, cfg.tsdf, cfg.blockmap))(f["jm"])
    got = tpc.extract_pointcloud_blocks(f["ts"].block_map(), tcfg.tsdf, tcfg.blockmap)
    return want, got


def test_extract_pointcloud_blocks_matches_jax(clouds):
    """Same count, same points in the same order (rank by flat index),
    within 1e-6 m; normals within 1e-5 (the gradient norm is an FMA chain
    under XLA)."""
    want, got = clouds
    n = int(want.count)
    assert int(got.count) == n > 5000
    assert got.points.shape == (1 << 20, 3) and got.valid.dtype == torch.bool
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) == n and bool(got.valid[:n].all())
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), rtol=0, atol=1e-5)
    assert not got.points[n:].any() and not got.normals[n:].any()


def test_points_lie_on_the_scene_surface(clouds):
    """Within two voxels of the analytic scene's zero level set on 99% of
    the points (measured: 99.7%, and 89.7% within one voxel; at 80x64 a
    pixel is wider than a voxel, which biases the fused surface)."""
    _, got = clouds
    f = fused()
    p = got.points[got.valid]
    d = SyntheticScene().sdf(p).abs().numpy()
    assert (d < 2 * f["tcfg"].tsdf.voxel_size).mean() >= 0.99
    nn = torch.linalg.vector_norm(got.normals[got.valid], dim=-1).numpy()
    np.testing.assert_allclose(nn, 1.0, atol=1e-5)


@pytest.mark.parametrize("max_points", [1, 100, 4097])
def test_capacity_truncates_in_order(clouds, max_points):
    """A cloud cut at ``max_points`` is the head of the full cloud."""
    f = fused()
    cfg, tcfg = f["cfg"], f["tcfg"]
    _, full = clouds
    got = tpc.extract_pointcloud_blocks(f["ts"].block_map(), tcfg.tsdf, tcfg.blockmap,
                                        max_points=max_points)
    want = jpc.extract_pointcloud_blocks(f["jm"], cfg.tsdf, cfg.blockmap, max_points=max_points)
    assert int(got.count) == int(want.count) == max_points
    assert got.points.shape == (max_points, 3) and bool(got.valid.all())
    assert torch.equal(got.points, full.points[:max_points])
    assert torch.equal(got.normals, full.normals[:max_points])
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-6)


def test_emit_matches_jax_on_random_masks():
    """``_emit`` alone, bit for bit: kept rows in flat-index order, the
    rest dropped, the tail zero."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(7, 5, 11, 3)).astype(np.float32)
    n = rng.normal(size=(7, 5, 11, 3)).astype(np.float32)
    for density, cap in ((0.0, 16), (0.3, 64), (0.3, 1000), (1.0, 385), (1.0, 384)):
        mask = rng.uniform(size=(7, 5, 11)) < density
        want = jpc._emit(jnp.asarray(p), jnp.asarray(n), jnp.asarray(mask), cap)
        got = tpc._emit(torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(mask), cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got.count.dtype == torch.int32


def test_surface_from_grid_matches_jax():
    """Eager JAX (nothing contracted but the norm): points within 1e-6,
    the surface mask equal."""
    rng = np.random.default_rng(3)
    tsdf = rng.uniform(-1, 1, size=(6, 8, 8, 8)).astype(np.float32)
    weight = rng.integers(0, 3, size=(6, 8, 8, 8)).astype(np.float32)
    pos = rng.normal(size=(6, 8, 8, 8, 3)).astype(np.float32)
    want = jpc._surface_from_grid(jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(pos), 0.04, 0.01)
    got = tpc._surface_from_grid(torch.from_numpy(tsdf), torch.from_numpy(weight),
                                 torch.from_numpy(pos), 0.04, 0.01)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.05 < got[2].float().mean() < 0.5


def test_save_ply_writes_the_same_file(clouds, tmp_path):
    """A cloud of 300 points, written by both packages: the same text,
    and the header's vertex count read back."""
    f = fused()
    cfg, tcfg = f["cfg"], f["tcfg"]
    got = tpc.extract_pointcloud_blocks(f["ts"].block_map(), tcfg.tsdf, tcfg.blockmap, max_points=300)
    # The JAX writer on the port's values: the files differ only if the writers do.
    same = jpc.PointCloud(jnp.asarray(got.points.numpy()), jnp.asarray(got.normals.numpy()),
                          jnp.asarray(got.valid.numpy()), jnp.asarray(got.count.numpy()))
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    assert tpc.save_ply(str(a), got) == jpc.save_ply(str(b), same) == 300
    assert a.read_text() == b.read_text()
    lines = a.read_text().splitlines()
    assert lines[2] == "element vertex 300" and len(lines) == 10 + 300
    assert len(lines[10].split()) == 6


def test_save_ply_skips_invalid_rows(tmp_path):
    pc = tpc.PointCloud(torch.arange(12.0).reshape(4, 3), torch.ones(4, 3),
                        torch.tensor([True, False, True, False]), torch.tensor(2, dtype=torch.int32))
    path = tmp_path / "c.ply"
    assert tpc.save_ply(str(path), pc) == 2
    rows = path.read_text().splitlines()[10:]
    assert rows == ["0.000000 1.000000 2.000000 1.0000 1.0000 1.0000",
                    "6.000000 7.000000 8.000000 1.0000 1.0000 1.0000"]


@pytest.fixture(scope="module")
def dense_clouds():
    f = fused_dense()
    cfg, tcfg = f["cfg"], f["tcfg"]
    want = jax.jit(lambda v: jpc.extract_pointcloud_dense(v, cfg.tsdf, cfg.dense))(f["vol"])
    got = tpc.extract_pointcloud_dense(f["tvol"], tcfg.tsdf, tcfg.dense)
    return want, got


def test_extract_pointcloud_dense_matches_jax(dense_clouds):
    """Same count and order as JAX (rank by the voxel's flat index), points
    within 1e-6 m, normals within 1e-5."""
    want, got = dense_clouds
    n = int(want.count)
    assert int(got.count) == n > 3000
    assert got.points.shape == (1 << 20, 3) and got.count.dtype == torch.int32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) == n and bool(got.valid[:n].all())
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), rtol=0, atol=1e-5)
    assert not got.points[n:].any() and not got.normals[n:].any()


def test_dense_points_lie_on_the_scene_surface(dense_clouds):
    """Within two voxels (3 cm) of the analytic scene's zero level set on
    99% of the points, unit normals, all inside the volume's box."""
    _, got = dense_clouds
    tcfg = fused_dense()["tcfg"]
    p = got.points[got.valid]
    d = SyntheticScene().sdf(p).abs().numpy()
    assert (d < 2 * tcfg.tsdf.voxel_size).mean() >= 0.99
    nn = torch.linalg.vector_norm(got.normals[got.valid], dim=-1).numpy()
    np.testing.assert_allclose(nn, 1.0, atol=1e-5)
    lo = torch.tensor(tcfg.dense.origin) - tcfg.tsdf.voxel_size
    hi = lo + (64 + 2) * tcfg.tsdf.voxel_size
    assert bool(((p >= lo) & (p <= hi)).all())


@pytest.mark.parametrize("max_points", [1, 100, 2049])
def test_dense_capacity_truncates_in_order(dense_clouds, max_points):
    f = fused_dense()
    _, full = dense_clouds
    got = tpc.extract_pointcloud_dense(f["tvol"], f["tcfg"].tsdf, f["tcfg"].dense,
                                       max_points=max_points)
    assert int(got.count) == max_points and bool(got.valid.all())
    assert torch.equal(got.points, full.points[:max_points])
    assert torch.equal(got.normals, full.normals[:max_points])


def test_empty_dense_volume_gives_no_points():
    from topfusion_tpu_torch.ops.tsdf_dense import make_dense_volume

    tcfg = fused_dense()["tcfg"]
    got = tpc.extract_pointcloud_dense(make_dense_volume(tcfg.dense), tcfg.tsdf, tcfg.dense,
                                       max_points=64)
    assert int(got.count) == 0 and not got.valid.any() and not got.points.any()
