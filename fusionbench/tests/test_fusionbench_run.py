"""The harness refuses to measure without a card, prints the contract's
result line, and its comparison holds a sound run and fails a broken
one."""

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from fusionbench import harness, spec

ROOT = spec.ROOT
SEED = 2**31 + 77
HASH, SLAM = "hash_vga.orbit", "slam_vga.live_orbit"


def _run(cell, overrides, fault=None, trace=False):
    return harness.run(cell, SEED, 1.0, trace, device="cpu", fault=fault,
                       overrides=overrides(cell))


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", HASH, "--seed", "1", "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_refuses_with_fewer_cards_than_the_cell(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert harness.main(["--workload", HASH, "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A checkout that holds only BENCHMARK.json and fusionbench/ exits
    non-zero and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fusionbench", tmp_path / "fusionbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "fusionbench.run", "--workload", HASH,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.parametrize("cell", [HASH, "hash_vga.corridor", SLAM])
def test_sound_run_is_correct(cell, tiny_overrides):
    out = _run(cell, tiny_overrides)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    names = {m["name"] for m in spec.cell(cell)["end_to_end"]}
    assert set(out["metrics"]) <= names and "setup_s" in out["metrics"]
    # The start and a run of whole chunks from a fresh map are compared
    # (a lap of the hash cells, the SLAM window's first chunks), besides
    # chunks from the program's own state.
    cuts = out["notes"]["compared_chunks"]
    assert ({-1, -2} <= set(cuts)) if cell != SLAM else (0 in cuts and min(cuts) < -1)


def test_result_line(tiny_overrides):
    out = _run(HASH, tiny_overrides)
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        harness.emit(out)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name}:" in err.getvalue()
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
@pytest.mark.parametrize("cell", [HASH, "hash_vga.corridor", SLAM])
def test_broken_step_is_not_correct(cell, fault, tiny_overrides):
    """The run with its timed path broken underneath: a step that returns
    its state unchanged, half of each frame left out, a pose altered
    where it is produced.  (One chip: no exchange between chips.)"""
    out = _run(cell, tiny_overrides, fault=fault)
    assert not out["correct"], out["checks"]
