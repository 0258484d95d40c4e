"""The batched 6x6 Jacobi eigensolver behind ``ops/icp.obs_ratio``: the
plain twin (``ops/icp.jacobi_eigvals6`` and ``ratio_from_eigvals``) of the
kernel ``csrc/eig6.cu``, on the CPU.

* Against ``np.linalg.eigvalsh`` in float64: seeded PSD batches with
  graded spectra (condition numbers 1 to 1e8), rank-deficient, zero,
  diagonal, already sorted and block-diagonal matrices: every eigenvalue
  within 1e-12 x lambda_max.
* The ratio against the JAX package's ``obs_ratio`` on ICP Gram matrices
  of the test orbit (one JAX run: tests/test_pipeline_block.py's 80x64
  configuration, 4 frames through the step, then ICP from that state to
  the next two frames in three gather modes), within 1e-4 as
  tests/test_torch_icp.py holds it: the two ICPs' Grams differ in their
  last bits.
* The wrapper: the twin on a CPU tensor, no fallback on another device,
  its launch count registered.

The card's cases (the kernel bit-equal to the twin on 10^4 matrices) are
in tests/test_torch_cuda.py.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.ops import icp as jicp
from topfusion_tpu.ops.depth import preprocess_depth as j_preprocess
from topfusion_tpu.ops.normals import build_maps_pyramid as j_maps
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.ops import icp as ticp
from topfusion_tpu_torch.ops.cuda.eig6 import obs_ratio_cuda
from topfusion_tpu_torch.utils import counters

torch.set_num_threads(2)

TOL = 1e-12  # of lambda_max


def graded(rng, n, log10_cond):
    """``n`` symmetric PSD float32 matrices with eigenvalues spaced
    geometrically over ``log10_cond`` decades, at random scales and in
    random bases."""
    q, _ = np.linalg.qr(rng.standard_normal((n, 6, 6)))
    lam = np.geomspace(1.0, 10.0 ** -log10_cond, 6)[None] * 10.0 ** rng.uniform(-3, 6, (n, 1))
    a = (q * lam[:, None, :]) @ q.transpose(0, 2, 1)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)


def reference(a: np.ndarray) -> np.ndarray:
    """float64 eigenvalues of the matrices' lower triangles."""
    a = a.astype(np.float64)
    low = np.tril(a)
    return np.linalg.eigvalsh(low + np.tril(a, -1).transpose(0, 2, 1))


def assert_spectra(a: np.ndarray) -> None:
    got = ticp.jacobi_eigvals6(torch.from_numpy(a))
    assert got.dtype == torch.float64 and got.shape == a.shape[:-1]
    want = reference(a)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-300)
    err = np.abs(got.numpy() - want) / scale
    assert err.max() <= TOL, err.max()
    assert (np.diff(got.numpy(), axis=-1) >= 0).all()  # ascending


@pytest.mark.parametrize("log10_cond", [0, 2, 4, 6, 8])
def test_graded_spectra_match_numpy(log10_cond):
    assert_spectra(graded(np.random.default_rng(log10_cond), 200, log10_cond))


def special(kind: str, rng) -> np.ndarray:
    n = 64
    if kind == "zero":
        return np.zeros((n, 6, 6), np.float32)
    if kind == "rank_deficient":  # ranks 1 to 5
        q, _ = np.linalg.qr(rng.standard_normal((n, 6, 6)))
        lam = rng.uniform(0.1, 10.0, (n, 6)) * (np.arange(6)[None] < rng.integers(1, 6, (n, 1)))
        a = (q * lam[:, None, :]) @ q.transpose(0, 2, 1)
        return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)
    if kind == "diagonal":
        return (np.eye(6)[None] * rng.uniform(-1.0, 5.0, (n, 1, 6))).astype(np.float32)
    if kind == "sorted_diagonal":
        return (np.eye(6)[None] * np.sort(rng.uniform(0.0, 5.0, (n, 1, 6)), -1)).astype(np.float32)
    if kind == "block_diagonal":  # pairs across the blocks are skipped from the start
        a = graded(rng, 2 * n, 2)[:, :3, :3]
        out = np.zeros((n, 6, 6), np.float32)
        out[:, :3, :3], out[:, 3:, 3:] = a[:n], a[n:]
        return out
    if kind == "repeated":  # a threefold eigenvalue
        q, _ = np.linalg.qr(rng.standard_normal((n, 6, 6)))
        lam = np.array([1.0, 1.0, 1.0, 2.0, 3.0, 1e-4])[None].repeat(n, 0)
        a = (q * lam[:, None, :]) @ q.transpose(0, 2, 1)
        return ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)
    if kind == "asymmetric":  # only the lower triangle is read
        return rng.standard_normal((n, 6, 6)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["zero", "rank_deficient", "diagonal", "sorted_diagonal",
                                  "block_diagonal", "repeated", "asymmetric"])
def test_special_matrices_match_numpy(kind):
    assert_spectra(special(kind, np.random.default_rng(len(kind))))


def test_sweeps_have_margin(monkeypatch):
    """Two sweeps fewer still meet the tolerance on the hardest spectra
    (condition 1e8, a close pair): the fixed count carries margin."""
    rng = np.random.default_rng(7)
    a = np.concatenate([graded(rng, 200, 8), special("repeated", rng)])
    monkeypatch.setattr(ticp, "JACOBI_SWEEPS", ticp.JACOBI_SWEEPS - 2)
    assert_spectra(a)


def test_sweep_count_matches_the_kernel():
    """The twin and ``csrc/eig6.cu`` run the same number of sweeps over
    the same pairs in the same order."""
    src = (Path(ticp.__file__).parents[1] / "csrc" / "eig6.cu").read_text()
    assert int(re.search(r"constexpr int kSweeps = (\d+);", src).group(1)) == ticp.JACOBI_SWEEPS
    body = src[src.index("void sweep("):]
    pairs = [tuple(map(int, m)) for m in re.findall(r"rotate<(\d), (\d)>\(a\)", body)]
    assert tuple(pairs) == ticp._PAIRS


def test_ratio_rounds_and_clamps_as_obs_ratio():
    """The float32 ratio of float32-rounded eigenvalues, clamped at 0 and
    1e-20; NaN propagates; the batch shape is kept."""
    eig = torch.tensor([[-1e-9, 1.0, 2.0, 3.0, 4.0, 5.0],
                        [1e-3, 1.0, 2.0, 3.0, 4.0, 8.0],
                        [0.0] * 6,
                        [float("nan"), 1.0, 2.0, 3.0, 4.0, 5.0]], dtype=torch.float64)
    r = ticp.ratio_from_eigvals(eig)
    assert r.dtype == torch.float32 and r.shape == (4,)
    assert float(r[0]) == 0.0 and float(r[2]) == 0.0 and np.isnan(float(r[3]))
    assert float(r[1]) == float(np.float32(np.float32(1e-3) / np.float32(8.0)))
    g = torch.from_numpy(graded(np.random.default_rng(3), 6, 3)).reshape(2, 3, 6, 6)
    batched = ticp.obs_ratio(g)
    assert batched.shape == (2, 3)
    assert torch.equal(batched[1, 2], ticp.obs_ratio(g[1, 2]))


def test_ratio_against_float64_numpy():
    """Within 2 float32 ulps of the float64 ratio (two roundings to
    float32, then one division)."""
    a = graded(np.random.default_rng(11), 500, 5)
    ev = reference(a)
    want = np.maximum(ev[:, 0], 0) / np.maximum(ev[:, 5], 1e-20)
    got = ticp.obs_ratio(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


# ----------------------------------------------------------------- ICP Grams
@pytest.fixture(scope="module")
def icp_grams():
    """(JAX obs_ratio, the port's Gram) per (frame, gather mode)."""
    cfg = make_cfg()
    scene = SyntheticScene()
    poses = orbit_trajectory(6, max_angle_deg=4.0, max_shift=0.04, seed=3)
    frames = [np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
              for T in poses]
    pipe = JaxPipeline(cfg)
    state = pipe.init()
    for f in frames[:4]:
        state, _ = pipe.step(state, jnp.asarray(f))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = []
    for f in frames[4:]:
        _, pyr = j_preprocess(jnp.asarray(f), cfg.preproc)
        cp, cn = j_maps(cfg.camera, pyr)
        for mode in ("flat", "take", "onehot"):
            icfg = dataclasses.replace(cfg.icp, gather_mode=mode)
            tcfg = config_from_reference(dataclasses.replace(cfg, icp=icfg))
            args = (state.T_wc, state.T_wc, list(cp), list(cn), list(state.model_points),
                    list(state.model_normals))
            rj = jicp.icp_track(cfg.camera, icfg, *args)
            rt = ticp.icp_track(tcfg.camera, tcfg.icp, *[
                [t(x) for x in a] if isinstance(a, list) else t(a) for a in args])
            out.append((float(rj.obs_ratio), rt.gram))
    return out


def test_ratio_of_icp_grams_matches_jax(icp_grams):
    """Each Gram's ratio within 1e-4 of the JAX package's, alone and in
    one batch as ``detect_loop`` makes it."""
    grams = torch.stack([g for _, g in icp_grams])
    batched = ticp.obs_ratio(grams)
    assert len(icp_grams) == 6
    for i, (want, g) in enumerate(icp_grams):
        assert 1e-6 < want < 1.0
        got = ticp.obs_ratio(g)
        np.testing.assert_allclose(float(got), want, rtol=1e-4)
        assert torch.equal(batched[i], got)


def test_icp_gram_spectra_match_numpy(icp_grams):
    assert_spectra(np.stack([g.numpy() for _, g in icp_grams]))


# ----------------------------------------------------------------- wrapper
def test_wrapper_runs_the_twin_on_the_cpu():
    g = torch.from_numpy(graded(np.random.default_rng(5), 16, 4)).reshape(2, 2, 4, 6, 6)
    before = obs_ratio_cuda.launches
    assert torch.equal(obs_ratio_cuda(g), ticp.obs_ratio_plain(g))
    assert torch.equal(ticp.obs_ratio(g), ticp.obs_ratio_plain(g))
    assert obs_ratio_cuda.launches == before  # the plain path is not a launch


def test_wrapper_refuses_other_devices_and_types():
    """No fallback: a tensor neither on the CPU nor on the card is
    refused, and so is a card tensor the kernel does not take (checked
    before any launch)."""
    with pytest.raises(ValueError, match="unsupported device"):
        obs_ratio_cuda(torch.empty((16, 6, 6), device="meta"))


def test_launch_count_is_registered():
    assert counters.read()[(obs_ratio_cuda, "launches")] == obs_ratio_cuda.launches
    assert counters.name(obs_ratio_cuda, "launches") == "obs_ratio_cuda.launches"
