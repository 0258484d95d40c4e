"""The port's config tree is the JAX package's, field for field, and the
port imports no jax."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import topfusion_tpu.config as jcfg
import topfusion_tpu_torch
import topfusion_tpu_torch.config as tcfg
from topfusion_tpu_torch.convert import config_from_reference

CLASSES = sorted(
    n for n, o in vars(jcfg).items()
    if isinstance(o, type) and dataclasses.is_dataclass(o) and o.__module__ == jcfg.__name__
)
PORT_DIR = pathlib.Path(topfusion_tpu_torch.__file__).parent


def assert_same_value(a, b, where):
    """Equal values; nested dataclasses compared by class name and fields."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), where
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same_value(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} vs {b!r}"


def test_same_dataclasses():
    port = sorted(
        n for n, o in vars(tcfg).items()
        if isinstance(o, type) and dataclasses.is_dataclass(o)
    )
    assert port == CLASSES


@pytest.mark.parametrize("name", CLASSES)
def test_fields_identical(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.type == b.type, f"{name}.{a.name} type"
        assert b.default_factory is dataclasses.MISSING
        assert_same_value(a.default, b.default, f"{name}.{a.name}")
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen


@pytest.mark.parametrize(
    "factory", ["default_config", "tiny_test_config", "reference_exact"]
)
def test_config_functions_agree(factory):
    if factory == "reference_exact":
        j = jcfg.reference_exact_config(jcfg.tiny_test_config())
        t = tcfg.reference_exact_config(tcfg.tiny_test_config())
    else:
        j, t = getattr(jcfg, factory)(), getattr(tcfg, factory)()
    assert_same_value(j, t, factory)
    # config_from_reference carries the JAX tree over unchanged.
    c = config_from_reference(j)
    assert isinstance(c, tcfg.PipelineConfig)
    assert c == t


def test_derived_values_agree():
    jc, tc = jcfg.CameraConfig(), tcfg.CameraConfig()
    for level in range(3):
        assert dataclasses.asdict(jc.at_level(level)) == dataclasses.asdict(tc.at_level(level))
    assert jc.shape == tc.shape
    assert jcfg.ICPConfig().angle_threshold_cos == tcfg.ICPConfig().angle_threshold_cos


def test_pool_weight_limit_enforced():
    bad = dict(tsdf=tcfg.TSDFConfig(max_weight=300.0),
               blockmap=tcfg.BlockMapConfig(pool_dtype="bfloat16"))
    with pytest.raises(ValueError):
        tcfg.PipelineConfig(**bad)


def test_config_from_reference_rejects_unknown_fields():
    @dataclasses.dataclass(frozen=True)
    class Other:
        camera: int = 0

    with pytest.raises(ValueError):
        config_from_reference(Other())


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    loading jax or the JAX package."""
    mods = sorted(
        "topfusion_tpu_torch." + ".".join(p.relative_to(PORT_DIR).with_suffix("").parts)
        for p in PORT_DIR.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'topfusion_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT_DIR.parent)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import topfusion_tpu\b|from topfusion_tpu\b)", re.M)
    for p in PORT_DIR.rglob("*.py"):
        assert not pat.search(p.read_text()), p


@pytest.mark.parametrize("value", [None, True, False, "flase"])
def test_resolve_pallas_integrate(value):
    """The kernel-or-plain choice: on the CPU the JAX package's choice for
    every value (None resolves to XLA there, the plain version here); on
    a CUDA device None picks the kernel.  A typo left a string picks the
    kernel, as the JAX package's ``bool()`` picks Pallas."""
    jb = dataclasses.replace(jcfg.BlockMapConfig(), use_pallas_integrate=value)
    tb = dataclasses.replace(tcfg.BlockMapConfig(), use_pallas_integrate=value)
    want_cpu = jcfg.resolve_pallas_integrate(jb)
    assert tcfg.resolve_pallas_integrate(tb, "cpu") is want_cpu
    assert tcfg.resolve_pallas_integrate(tb, torch.device("cpu")) is want_cpu
    want_cuda = value is None or want_cpu
    assert tcfg.resolve_pallas_integrate(tb, "cuda") is want_cuda
    assert tcfg.resolve_pallas_integrate(tb, torch.device("cuda", 0)) is want_cuda
