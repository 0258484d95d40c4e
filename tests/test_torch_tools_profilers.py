"""The port's profilers and measurers (``topfusion_tpu_torch.tools``) on
the CPU at small sizes: each runs and prints the JAX script's rows in
the JAX script's order (``profile_stages`` names the integrate rows by
the port's two versions, plain PyTorch and the CUDA kernel, where the
JAX script names XLA and Pallas); ``measure_collectives`` on a gloo
world of 2 counts the same bytes per step at two map capacities; and no
tool module imports jax, imageio or the JAX package."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from topfusion_tpu_torch.config import tiny_test_config
from topfusion_tpu_torch.tools.bench_config import bench_config
from topfusion_tpu_torch.tools import (
    bisect_preproc,
    calibrate,
    measure_collectives,
    measure_scaling,
    micro_primitives,
    profile_app,
    profile_stages,
    profile_sub,
    timing,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench", "bench_config", "bisect_preproc", "calibrate", "integrate_sweep", "make_synthetic_dataset",
         "measure_collectives", "measure_scaling", "micro_primitives", "parity_ab", "profile_app",
         "profile_stages", "profile_sub", "timing", "view")

torch.set_num_threads(2)


def printed(fn, *args, **kw) -> list:
    """The lines ``fn`` prints; the worlds it spawns run two threads a
    process, as the test processes do."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setenv("OMP_NUM_THREADS", "2")
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def run(tool, *argv) -> list:
    """The lines the tool's command line prints, on the CPU."""
    rc = []
    lines = printed(lambda: rc.append(tool.main([*argv, "--device", "cpu"])))
    assert rc == [0]
    return lines


def row_names(lines, names):
    """The names of ``names`` that start a line (padded: two spaces
    after them), in the order printed."""
    return [n for ln in lines for n in names if ln.startswith(n + "  ")]


STAGES = ["preprocess_depth", "build_maps_pyramid", "icp_track(4,3,2)", "allocate_from_depth",
          "visible_blocks", "integrate_blocks(plain)", "integrate_blocks(cuda)",
          "splat_model_maps", "raycast guided", "raycast full", "resize_points_normals",
          "FULL step", "sum of the step's stages", "sum / FULL step"]


def test_profile_stages_rows():
    lines = printed(profile_stages.run, tiny_test_config(), "cpu", n=1)
    assert row_names(lines, STAGES) == STAGES
    full = next(ln for ln in lines if ln.startswith("FULL step "))
    assert "lat " in full and "pipelined " in full and "device " in full and "ops " in full


def test_profile_sub_rows():
    names = ["depth_to_meters", "bilateral 7x7", "downsample L1", "preprocess full",
             "splat NEW", "FULL step"]
    assert row_names(printed(profile_sub.run, tiny_test_config(), "cpu", n=1), names) == names


def test_bisect_preproc_rows():
    names = ["depth_to_meters", "bilateral 7x7", "bilateral 5x5", "downsample",
             "49-tap shifted sum (no exp)", "49-tap shifted exp sum", "49 exps, no shifts",
             "49-tap roll sum", "49-tap vertical-only shifts", "49-tap horizontal-only shifts"]
    assert row_names(printed(bisect_preproc.run, "cpu", n=1), names) == names


def test_micro_primitives_rows():
    names = ["scatter-min 524k -> 307k img", "scatter-min 131k -> 307k img",
             "scatter-set 2M -> 131k (compaction)", "scatter-set 524k -> 131k",
             "scatter-add 524k scalar -> 307k", "sort 600k i32", "sort 150k i32", "sort 2M i32",
             "sort 600k i32 + argsort payload", "cumsum 2M i32", "cumsum 600k i32",
             "gather 4k x 512-rows from 128MB pool", "gather 307k x 8 from 9.8MB",
             "gather 307k scalar from 1.2MB img", "rowwise take_along 64-band 307k",
             "one-hot band gather 307k (bmm 4800x64x64x8)"]
    assert row_names(printed(micro_primitives.run, "cpu", n=1), names) == names


def test_row_format_counts_agreeing_sessions():
    """A row gives the most operations its profiler sessions counted and
    how many of them counted as many; the CPU's rows have no device
    columns."""
    timer = timing.Timer("cpu")
    rec = dict(name="build_maps_pyramid", lat_ms=1.0, pipelined_ms=0.5, device_ms=0.25, ops=135,
               sessions=[135, 112, 135])
    assert timer.format(rec).endswith("ops    135   (2/3 agree)")
    assert timer.format(dict(rec, device_ms=None, ops=None, sessions=None)).endswith(
        "device         - ms   ops      -")


def test_calibrate_rows():
    lines = run(calibrate)
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "trivial op, sync each call", "trivial op, chained x100", "matmul 480x640 chained x30"]
    assert all(float(ln.split(":")[1].split()[0]) >= 0 for ln in lines)


def test_profile_app_rows():
    lines = printed(profile_app.run, tiny_test_config(), "cpu", n=20, chunk=10)
    assert lines[0].startswith("warmup ")
    assert [ln.split(":")[0] for ln in lines[1:3]] == ["chunk 0", "chunk 1"]
    for part in ("dispatch", "exec-fence", "fetch", "loop closure", "bookkeeping",
                 "full process_chunk"):
        assert part in lines[1]
    assert lines[3].startswith("render: ")


@pytest.mark.parametrize("tool", [profile_stages, profile_sub, profile_app],
                         ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_command_line_runs_bench_config(tool, monkeypatch):
    """The command line takes the JAX script's flags and ``--device``, and
    runs at the bench configuration (here only recorded: it is VGA)."""
    got = []
    monkeypatch.setattr(tool, "run", lambda cfg, device: got.append((cfg, device)))
    assert tool.main(["--device", "cpu"]) == 0
    assert got == [(bench_config(), torch.device("cpu"))]
    with pytest.raises(SystemExit):
        tool.main(["--tiny", "--device", "cpu"])


@pytest.mark.parametrize("tool", [profile_stages, profile_sub, profile_app, bisect_preproc,
                                  micro_primitives, calibrate],
                         ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_command_line_raises_without_card(tool, monkeypatch):
    """The default device is the card; with none the tool raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([])


def test_measure_scaling_json():
    """One JSON line per mode; a world of 1 alone gives no efficiency."""
    lines = printed(measure_scaling.run, tiny_test_config(), "cpu", [1], n_frames=2)
    rows = [json.loads(ln) for ln in lines]
    assert [r["mode"] for r in rows] == ["weak", "strong"]
    for r in rows:
        assert r["1"] > 0 and r["backend"] == {"1": "gloo"} and r["efficiency"] is None


@pytest.fixture(scope="module")
def collectives():
    return run(measure_collectives, "--devices", "2")


def test_measure_collectives_rows(collectives):
    rows = [json.loads(ln) for ln in collectives if ln.startswith("{")]
    assert [(r["image"], r["capacity"]) for r in rows] == [
        ("80x64", 4096), ("160x128", 4096), ("320x256", 4096), ("160x128", 16384)]
    assert all(r["devices"] == 2 and r["ok"] and r["calls"] > 0 for r in rows)
    assert any(ln.startswith("image-scaling exponent vs area: ") for ln in collectives)
    assert any(ln.startswith("capacity x4 -> collective volume x") for ln in collectives)


def test_collective_bytes_independent_of_capacity(collectives):
    rows = {(r["image"], r["capacity"]): r for r in
            (json.loads(ln) for ln in collectives if ln.startswith("{"))}
    small, big = rows["160x128", 4096], rows["160x128", 16384]
    assert small["total_bytes"] == big["total_bytes"] > 0
    assert small["calls"] == big["calls"]


@pytest.fixture(scope="module")
def imported():
    """Every tool module imported in a process where jax, imageio and the
    JAX package cannot be imported: the modules it loaded."""
    code = ("import sys, json, importlib\n"
            "for m in ('jax', 'imageio', 'topfusion_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for t in {TOOLS!r}:\n"
            "    importlib.import_module('topfusion_tpu_torch.tools.' + t)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax(imported, tool):
    assert f"topfusion_tpu_torch.tools.{tool}" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "imageio")
                and m not in ("jax", "imageio")]
    assert not [m for m in imported if m.startswith("topfusion_tpu.")]
