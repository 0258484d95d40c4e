"""The port's public surface against the JAX package's: the names that
``geometry``, ``ops`` and ``io`` export, ``intrinsics_matrix``,
``io.synthetic.make_sequence`` and ``utils.device_info.print_device_info``."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tests.test_pipeline_block import make_cfg
from topfusion_tpu.geometry.camera import intrinsics_matrix as j_intrinsics
from topfusion_tpu.io.synthetic import make_sequence as j_make_sequence
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.geometry.camera import intrinsics_matrix
from topfusion_tpu_torch.io.synthetic import make_sequence
from topfusion_tpu_torch.utils.device_info import device_banner, print_device_info

torch.set_num_threads(2)


@pytest.mark.parametrize("sub", ["geometry", "ops", "io"])
def test_subpackages_export_the_jax_names(sub):
    """The same ``__all__``, each name the port's own function of that name
    (none is the JAX package's)."""
    ours = importlib.import_module(f"topfusion_tpu_torch.{sub}")
    ref = importlib.import_module(f"topfusion_tpu.{sub}")
    assert ours.__all__ == ref.__all__
    for name in ours.__all__:
        obj = getattr(ours, name)
        assert obj.__module__.startswith(f"topfusion_tpu_torch.{sub}."), (name, obj.__module__)
        assert obj.__name__ == getattr(ref, name).__name__


@pytest.mark.parametrize("flip", [1.0, -1.0])
def test_intrinsics_matrix_matches_jax(flip):
    """Equal, the ICL convention fy < 0 as well, in float32 and float64."""
    jc = make_cfg().camera
    jc = dataclasses.replace(jc, fy=flip * jc.fy)
    tc = config_from_reference(dataclasses.replace(make_cfg(), camera=jc)).camera
    K = intrinsics_matrix(tc)
    assert K.dtype == torch.float32 and K.device.type == "cpu"
    np.testing.assert_array_equal(K.numpy(), np.asarray(j_intrinsics(jc)))
    np.testing.assert_array_equal(intrinsics_matrix(tc, dtype=torch.float64).numpy(),
                                  np.asarray(j_intrinsics(jc)).astype(np.float64))


def test_make_sequence_matches_jax():
    """The same ground-truth poses (to 1e-6, as tests/test_torch_frontend.py
    holds orbit_trajectory) and frames within
    test_synthetic_depth_frames' tolerance: a rare pixel a millimetre off
    or flipped at a silhouette; u16 numpy frames."""
    cfg = make_cfg()
    kw = dict(max_angle_deg=4.0, max_shift=0.04)
    dj, pj, _ = j_make_sequence(cfg.camera, 3, seed=3, **kw)
    dt, pt, scene = make_sequence(config_from_reference(cfg).camera, 3, seed=3, device="cpu", **kw)
    assert type(scene).__name__ == "SyntheticScene" and len(dt) == len(pt) == 3
    np.testing.assert_allclose(np.stack(pt), np.stack(pj), atol=1e-6)
    for a, b in zip(dt, dj):
        assert isinstance(a, np.ndarray) and a.dtype == np.uint16
        a, b = a.astype(np.int32), np.asarray(b).astype(np.int32)
        assert a.shape == b.shape and (b > 0).mean() > 0.5
        assert (a != b).mean() <= 0.005
        both = (a > 0) & (b > 0)
        assert np.abs(a - b)[both].max() <= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_sequence(config_from_reference(cfg).camera, 1)


@pytest.mark.parametrize("verbose", [False, True])
def test_print_device_info_prints_the_banner(capsys, verbose):
    print_device_info(verbose)
    out = capsys.readouterr().out
    assert out == device_banner(verbose) + "\n"
    assert out.startswith(f"torch {torch.__version__}")
