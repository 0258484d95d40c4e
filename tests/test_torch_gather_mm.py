"""Port vs JAX package: the banded projective gather
(``topfusion_tpu_torch/ops/gather_mm.py``) against
``topfusion_tpu.ops.gather_mm.banded_projective_gather`` on the same numpy
inputs.  ``in_band`` must be equal and the values bitwise equal, with
-0.0 and +0.0 counted equal (the JAX one-hot sum may turn a selected -0.0
into +0.0; see the port's module docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topfusion_tpu.ops.gather_mm import banded_projective_gather as j_gather
from topfusion_tpu_torch.ops.gather_mm import banded_projective_gather as t_gather

torch.set_num_threads(2)


def near_rows(rng, H, W, h, w, spread):
    """Queries near their nominal row ``i * H / h`` within +-spread,
    clipped to the map (as tests/test_gather_mm.py draws them)."""
    vi = (H // h * np.arange(h))[:, None] + rng.integers(-spread, spread, size=(h, w))
    return rng.integers(0, W, size=(h, w)), np.clip(vi, 0, H - 1)


def case(name):
    """(model [H, W, C], u [h, w], v [h, w], keyword arguments)."""
    if name == "exact_in_band":  # tests/test_gather_mm.py::test_exact_in_band
        model = np.random.default_rng(0).normal(size=(64, 80, 6))
        ui, vi = near_rows(np.random.default_rng(1), 64, 80, 32, 40, 10)
        return model, ui, vi, dict(v_margin=16)
    if name == "out_of_band":  # ::test_out_of_band_flagged
        model = np.random.default_rng(0).normal(size=(64, 80, 3))
        return model, np.full((32, 40), 5), np.full((32, 40), 0), dict(v_margin=8)
    if name == "full_res":  # ::test_full_res_query_grid
        model = np.random.default_rng(3).normal(size=(48, 64, 6))
        rng = np.random.default_rng(4)
        vi = np.clip(np.arange(48)[:, None] + rng.integers(-6, 6, size=(48, 64)), 0, 47)
        return model, rng.integers(0, 64, size=(48, 64)), vi, dict(v_margin=12)
    rng = np.random.default_rng(7)
    if name.startswith("stride"):  # query grids 1, 2 and 4 times coarser than the map
        s = int(name[-1])
        model = rng.normal(size=(96, 72, 6))
        ui, vi = near_rows(rng, 96, 72, 96 // s, 72 // s, 40)
        return model, ui, vi, dict(v_margin=10)
    if name == "rows_per_tile":
        model = rng.normal(size=(64, 40, 6))
        ui, vi = near_rows(rng, 64, 40, 32, 40, 12)
        return model, ui, vi, dict(v_margin=6, rows_per_tile=4)
    if name == "tile_not_dividing":  # h = 30: the default tr = 16 falls to 15
        model = rng.normal(size=(60, 50, 6))
        ui, vi = near_rows(rng, 60, 50, 30, 50, 20)
        return model, ui, vi, dict(v_margin=5)
    if name == "margin_0":  # bands of one tile's rows: cuts at tile edges
        model = rng.normal(size=(64, 80, 6))
        ui, vi = near_rows(rng, 64, 80, 32, 40, 6)
        return model, ui, vi, dict(v_margin=0)
    if name == "off_the_map":  # negative, out-of-range and int32-extreme indices
        model = rng.normal(size=(32, 48, 6))
        ui, vi = near_rows(rng, 32, 48, 32, 48, 4)
        bad = rng.random((32, 48)) < 0.3
        ui = np.where(bad, rng.choice([-1, -7, 48, 1000, -2**31, 2**31 - 1], size=ui.shape), ui)
        bad = rng.random((32, 48)) < 0.3
        vi = np.where(bad, rng.choice([-1, -3, 32, 500, -2**31, 2**31 - 1], size=vi.shape), vi)
        return model, ui, vi, dict(v_margin=8)
    if name == "band_taller_than_map":
        model = rng.normal(size=(40, 30, 6))
        ui, vi = near_rows(rng, 40, 30, 20, 30, 40)
        return model, ui, vi, dict(v_margin=64)
    raise ValueError(name)


CASES = ["exact_in_band", "out_of_band", "full_res", "stride1", "stride2", "stride4",
         "rows_per_tile", "tile_not_dividing", "margin_0", "off_the_map",
         "band_taller_than_map"]


@pytest.mark.parametrize("name", CASES)
def test_banded_gather_matches_jax(name):
    model, ui, vi, kw = case(name)
    model = model.astype(np.float32)
    # Signed zeros and exact zeros, as the model maps hold at invalid pixels.
    model[::5, ::3] = 0.0
    model[1::7, ::4] = -0.0
    ui, vi = ui.astype(np.int32), vi.astype(np.int32)
    out_j, ok_j = j_gather(jnp.asarray(model), jnp.asarray(ui), jnp.asarray(vi), **kw)
    out_t, ok_t = t_gather(torch.from_numpy(model), torch.from_numpy(ui), torch.from_numpy(vi), **kw)
    out_j, ok_j = np.asarray(out_j), np.asarray(ok_j)
    assert out_t.dtype == torch.float32 and ok_t.dtype == torch.bool
    assert out_t.shape == out_j.shape and ok_t.shape == ok_j.shape
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    # Bitwise, with +-0 equal: +0.0 added to both sides maps -0.0 to +0.0.
    np.testing.assert_array_equal((out_t.numpy() + 0.0).view(np.int32),
                                  (out_j + 0.0).view(np.int32))
    # Not a trivial case: some queries in band, and they read the map.
    assert ok_j.any()
    if name == "out_of_band":
        assert ok_j[0].all() and not ok_j[-1].any()
    if name in ("margin_0", "off_the_map"):
        assert not ok_j.all()
    H, W = model.shape[:2]
    inside = ok_j & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    np.testing.assert_array_equal(out_t.numpy()[inside],
                                  model[np.clip(vi, 0, H - 1), np.clip(ui, 0, W - 1)][inside])


def test_banded_gather_under_vmap():
    """Under ``torch.func.vmap`` (as detect_loop runs ICP) it equals the
    per-item calls."""
    rng = np.random.default_rng(9)
    model = torch.from_numpy(rng.normal(size=(3, 32, 40, 6)).astype(np.float32))
    ui = torch.from_numpy(rng.integers(-4, 44, size=(3, 16, 20)).astype(np.int32))
    vi = torch.from_numpy(rng.integers(-4, 36, size=(3, 16, 20)).astype(np.int32))
    out, ok = torch.func.vmap(lambda m, u, v: t_gather(m, u, v, v_margin=6))(model, ui, vi)
    for k in range(3):
        o, b = t_gather(model[k], ui[k], vi[k], v_margin=6)
        assert torch.equal(out[k], o) and torch.equal(ok[k], b)
    assert ok.any() and not ok.all()
