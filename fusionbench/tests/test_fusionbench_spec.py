"""Every cell and metric of BENCHMARK.json resolves to its files by
name, within the contract's shapes."""

import json
import re

import pytest

from fusionbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fusionbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    c = spec.cell(w["name"])
    assert c["config"]["entry"]
    spec.driver(c["config"]["entry"])
    assert w["chips"] in (1, 4)
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert callable(spec.metric_reader(m["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if "moves" in m:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    d = spec.load_json(spec.ROOT / c["file"])
    assert c["file"].startswith("fusionbench/") and d["source"] == c["source"]
    assert d["reduced"] == c["reduced"] and "limits" in d
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A metric added as a file is read by the harness without an edit."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "extra.metric.py").write_text("def read(run):\n    return 1.5\n")
    monkeypatch.setattr(spec, "PKG", tmp_path)
    assert spec.metric_reader("extra.metric").read(None) == 1.5
