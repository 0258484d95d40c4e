"""The display shaders and the pipeline's four render modes against the
JAX package.  Images are uint8 after truncation: a last-bit difference
upstream (``pow``, XLA's contracted multiply-adds) can move a value across
an integer, so every pixel must be within ONE grey level."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raycast import fused, view_pose
from topfusion_tpu.ops import rendering as jr
from topfusion_tpu_torch.ops import rendering as tr
from topfusion_tpu_torch.utils.numerics import linspace01

torch.set_num_threads(2)

GREY_TOL = 1


def grey_diff(a, b):
    return np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))


def surface_maps(h, w, seed=0):
    """A random point map with unit normals and a third of it invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, size=(h, w, 3)).astype(np.float32)
    pts[..., 2] += 2.0
    nrm = rng.normal(size=(h, w, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    invalid = rng.uniform(size=(h, w)) < 0.33
    pts[invalid] = 0.0
    nrm[invalid] = 0.0
    return pts, nrm, invalid


@pytest.mark.parametrize("k", [1, 2, 4, 7, 64, 199, 200, 240, 480, 481, 720, 1080, 2160])
def test_linspace01_matches_jnp_linspace(k):
    """The background gradient's ramp at every image height in use (VGA
    has 480 rows) and beyond, to the bit."""
    np.testing.assert_array_equal(
        linspace01(k, "cpu").numpy(),
        np.asarray(jnp.linspace(0.0, 1.0, k, dtype=jnp.float32)))


@pytest.mark.parametrize("shape", [(64, 80), (480, 64)])
@pytest.mark.parametrize("with_view", [False, True])
def test_phong_shade(shape, with_view):
    pts, nrm, invalid = surface_maps(*shape)
    light = np.array([0.1, -1.0, -1.2], np.float32)
    view = np.array([0.1, 0.0, -0.2], np.float32) if with_view else None
    want = np.asarray(jr.phong_shade(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(light),
                                     None if view is None else jnp.asarray(view)))
    got = tr.phong_shade(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(light),
                         None if view is None else torch.from_numpy(view))
    assert got.dtype == torch.uint8 and got.shape == shape + (3,)
    d = grey_diff(got.numpy(), want)
    assert d.max() <= GREY_TOL
    # The background gradient has no pow in it: equal to the bit.
    np.testing.assert_array_equal(got.numpy()[invalid], want[invalid])
    assert (d > 0).mean() < 0.02


def test_render_confidence_rgb():
    rng = np.random.default_rng(1)
    conf = rng.integers(0, 140, size=(64, 80)).astype(np.float32)
    hit = rng.uniform(size=(64, 80)) < 0.7
    want = np.asarray(jr.render_confidence_rgb(jnp.asarray(conf), jnp.asarray(hit), 100.0))
    got = tr.render_confidence_rgb(torch.from_numpy(conf), torch.from_numpy(hit), 100.0)
    assert got.dtype == torch.uint8
    assert grey_diff(got.numpy(), want).max() <= GREY_TOL
    assert not got.numpy()[~hit].any()


def test_render_normals_rgb():
    _, nrm, invalid = surface_maps(64, 80, seed=2)
    want = np.asarray(jr.render_normals_rgb(jnp.asarray(nrm)))
    got = tr.render_normals_rgb(torch.from_numpy(nrm))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[invalid].any()


# ----------------------------------------------------------------- pipeline
def differing(got, want):
    """Share of pixels more than GREY_TOL apart."""
    return (grey_diff(got, want).max(-1) > GREY_TOL).mean()


@pytest.mark.parametrize("pose", [None, "novel"])
def test_pipeline_render(pose):
    """``render`` at the tracked pose and at a pose given as a numpy
    array.  The JAX march and the port's differ in the last bits of the
    hit points (tests/test_torch_raycast.py); the normals are differences
    of those points, so a pixel on a depth edge can shade differently: at
    most 1% of the pixels may be more than one grey level apart."""
    f = fused()
    if pose is None:
        want, got = f["jp"].render(f["js"]), f["tp"].render(f["ts"])
    else:
        T = view_pose(pose, f)
        want, got = f["jp"].render(f["js"], jnp.asarray(T)), f["tp"].render(f["ts"], T)
    assert got.dtype == torch.uint8 and got.shape == (64, 80, 3)
    assert differing(got.numpy(), want) <= 0.01
    lit = got.numpy()[..., 0] != got.numpy()[..., 2]      # the background is bluish
    assert 0.3 < (~lit).mean() <= 1.0 and got.numpy().std() > 10


@pytest.mark.parametrize("mode", ["render_normals", "render_confidence", "render_color"])
def test_pipeline_render_modes(mode):
    f = fused()
    want = np.asarray(getattr(f["jp"], mode)(f["js"]))
    got = getattr(f["tp"], mode)(f["ts"])
    assert got.dtype == torch.uint8 and got.shape == (64, 80, 3)
    assert differing(got.numpy(), want) <= 0.01
    assert (got.numpy().sum(-1) > 30).sum() > 1000


def test_render_color_shows_the_scene_palette():
    """Hit pixels carry the albedo of the primitive they see, dimmed as
    the JAX package dims it: the color average runs on the weight the
    depth pass has already raised, so after n frames a voxel holds
    n/(n+1) of its observed color (8/9 here).  The dominant channel
    matches the scene's ``color_at`` on 95% of the hits and the median
    brightness ratio is 8/9 within 0.03."""
    from topfusion_tpu.io.synthetic import SyntheticScene

    f = fused()
    img = f["tp"].render_color(f["ts"]).numpy().astype(np.float32)
    rc = f["tp"]._free_view_raycast(f["ts"], f["ts"].T_wc)
    hit = rc.hit.numpy()
    albedo = np.asarray(SyntheticScene().color_at(jnp.asarray(rc.points.numpy()))) * 255.0
    assert hit.sum() > 2000
    assert (img[hit].argmax(-1) == albedo[hit].argmax(-1)).mean() > 0.95
    ratio = np.median(img[hit].sum(-1) / albedo[hit].sum(-1))
    assert abs(ratio - 8.0 / 9.0) < 0.03


def test_renders_do_not_modify_the_state():
    f = fused()
    snap = [x.clone() for x in f["ts"].block_map()] + [f["ts"].T_wc.clone()]
    f["tp"].render(f["ts"])
    f["tp"].render_color(f["ts"])
    assert all(torch.equal(a, b) for a, b in zip(snap, list(f["ts"].block_map()) + [f["ts"].T_wc]))
