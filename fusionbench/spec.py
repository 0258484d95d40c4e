"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the
configuration as it is run: its source, its ``entry``, the pipeline's
every field, the limits of the comparison that decides ``correct``) and
``traffic/<traffic>.json`` (the parameters the one traffic generator,
``fusionbench/traffic.py``, reads).  A metric ``<name>`` is read by
``metrics/<name>.py``'s ``read(run)``; a configuration's ``entry`` is
driven by ``drivers/<entry>.py``.  A later cell, configuration, mix or
metric is new files and new entries, and no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded under a name of its own."""
    return _module(PKG / "metrics" / f"{name}.py", "fusionbench_metric_" + name.replace(".", "_"))


def driver(entry: str):
    """``drivers/<entry>.py``."""
    if not (PKG / "drivers" / f"{entry}.py").is_file():
        raise FileNotFoundError(f"no driver drivers/{entry}.py")
    return importlib.import_module(f"fusionbench.drivers.{entry}")


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything one cell needs: its ``workloads`` entry, its
    configuration and traffic files (parsed), and the metrics it reports
    with ``--trace 0`` (``end_to_end``) and ``--trace 1`` (``per_layer``)."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {
        "workload": w,
        "config": load_json(ROOT / cfg["file"]),
        "traffic": load_json(PKG / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": e2e,
        "per_layer": layer,
    }
