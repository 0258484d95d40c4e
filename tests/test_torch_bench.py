"""The port's benchmark (``topfusion_tpu_torch.tools.bench``) on the CPU at
the test config: its three scenarios run by the JAX package's
``bench.py`` protocol (the sharded one on a gloo world of one process)
and print ``bench.py``'s JSON keys and metric names, with ``vs_baseline``
the rate over the 30 frames/s sensor.

``bench.py`` is read as text, not imported: importing it points JAX's
compilation cache at a fixed directory."""

import ast
import contextlib
import io
import json
import os

import pytest
import torch

from topfusion_tpu_torch.config import tiny_test_config
from topfusion_tpu_torch.tools import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def reference():
    """bench.py's scenarios: {function: (result keys, metric)}, and the
    keys ``main`` adds to the orbit's line."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    scenarios, extras = {}, set()
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
                keys = [k.value for k in node.value.keys]
                metric = node.value.values[keys.index("metric")].value
                scenarios[fn.name] = (keys, metric)
            if (fn.name == "main" and isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Store)
                    and getattr(node.value, "id", None) == "result"):
                extras.add(node.slice.value)
    return scenarios, extras


REFERENCE, EXTRAS = reference()
STEPS = {"bench_orbit": 2 + 8 + 8, "bench_sweep": 16, "bench_sharded_orbit": 2 + 8 + 8}


@pytest.fixture(scope="module")
def results():
    """The three scenarios at the test config on the CPU, with what each
    leaves in ``detail``."""
    cfg = tiny_test_config()
    out = {}
    for name, fn, kw in (
        ("bench_orbit", bench.bench_orbit, dict(passes=1)),
        ("bench_sweep", bench.bench_sweep, dict(n_frames=16)),
        ("bench_sharded_orbit", bench.bench_sharded_orbit, dict(passes=1)),
    ):
        detail = {}
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            res = fn(cfg, "cpu", detail=detail, **kw)
        out[name] = (res, detail, err.getvalue())
    return out


def test_reference_has_three_scenarios():
    assert set(REFERENCE) == {"bench_orbit", "bench_sweep", "bench_sharded_orbit"}
    assert EXTRAS == {"pallas_agreement", "sharded_mesh1_fps", "sharded_vs_unsharded"}


@pytest.mark.parametrize("name", ["bench_orbit", "bench_sweep", "bench_sharded_orbit"])
def test_scenario_prints_bench_py_keys(results, name):
    res, detail, _ = results[name]
    keys, metric = REFERENCE[name]
    assert list(res) == keys
    assert res["metric"] == metric and res["unit"] == "frames/s"
    assert res["value"] > 0
    assert res["vs_baseline"] == pytest.approx(res["value"] / bench.BASELINE_FPS, abs=1e-3)
    # Every frame is stepped and tracked, and the state carried through
    # all of them: the orbit's two bootstrap steps, its warm-up chunk and
    # one timed chunk; the sweep's timed pass from a fresh map.
    aux = torch.cat([a.ok for a in detail["auxes"]])
    assert len(aux) == detail["frames"] and bool(aux.all())
    assert int(detail["state"].frame) == STEPS[name]


def test_orbit_protocol(results):
    """Six timed chunks of the 8-frame orbit by default; one here."""
    _, detail, _ = results["bench_orbit"]
    assert bench.PASSES == 6 and bench.ORBIT_FRAMES == bench.CHUNK == 8
    assert detail["frames"] == 8 and len(detail["auxes"]) == 1
    assert detail["auxes"][0].num_blocks.shape == (8,)


def test_sweep_allocates_every_chunk_from_a_fresh_map(results):
    """The timed sweep starts from an empty map (frame 0 allocates the
    first blocks), keeps allocating down the corridor, drops nothing, and
    reports its allocation on stderr as bench.py does."""
    _, detail, err = results["bench_sweep"]
    assert detail["frames"] == 16 and len(detail["auxes"]) == 2
    alloc = torch.cat([a.blocks_allocated for a in detail["auxes"]])
    num = torch.cat([a.num_blocks for a in detail["auxes"]])
    assert int(num[0]) == int(alloc[0]) > 0
    assert bool((alloc[1:] > 0).all()) and detail["blocks_dropped"] == 0
    assert int(num[-1]) == detail["num_blocks"] == int(alloc.sum())
    assert err.startswith("sweep: ") and f"{detail['num_blocks']} total" in err


def test_sharded_world_of_one_is_the_orbit(results):
    """A gloo world of one steps the orbit as the unsharded pipeline does:
    the same counts every frame."""
    _, one, _ = results["bench_orbit"]
    _, sharded, _ = results["bench_sharded_orbit"]
    assert sharded["backend"] == "gloo"
    for field in ("ok", "num_blocks", "blocks_allocated", "num_visible", "num_inliers"):
        assert torch.equal(getattr(sharded["auxes"][0], field), getattr(one["auxes"][0], field)), field


def test_main_prints_one_json_line_with_the_extras(monkeypatch):
    """``main`` on the CPU: one JSON line, the orbit's keys and bench.py's
    extras; the agreement gate skips without a card."""
    cfg = tiny_test_config()
    monkeypatch.setattr("topfusion_tpu_torch.tools.bench_config.bench_config", lambda dtype: cfg)
    monkeypatch.setattr(bench, "bench_orbit", lambda c, d: bench._result(
        "fused_depth_frames_per_s_per_chip", 12.0))
    monkeypatch.setattr(bench, "bench_sharded_orbit", lambda c, d: bench._result(
        "sharded_mesh1_frames_per_s_per_chip", 9.0))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    keys, _ = REFERENCE["bench_orbit"]
    assert list(line) == keys + ["pallas_agreement", "sharded_mesh1_fps", "sharded_vs_unsharded"]
    assert line["pallas_agreement"] == "skip"
    assert line["sharded_mesh1_fps"] == 9.0 and line["sharded_vs_unsharded"] == 0.75


def test_command_line_takes_bench_py_flags():
    """The JAX script's flags plus ``--device``; no ``--tiny``."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        text = f.read()
    want = {"--scenario", "--pool-dtype", "--no-extras"}
    assert all(f'"{flag}"' in text for flag in want)
    helptext = io.StringIO()
    with contextlib.redirect_stdout(helptext), pytest.raises(SystemExit):
        bench.main(["--help"])
    got = helptext.getvalue()
    assert all(flag in got for flag in want | {"--device"})
    assert "--tiny" not in got
