"""Find a cell's configuration, traffic, driver and metrics by name.

``BENCHMARK.json`` at the checkout's root names everything; each name
resolves to a file under ``port_bench/``: ``configs/<file>``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` (the traffic file's
``driver``) and ``metrics/<metric>.py``; a metric split by cell, such as
``device.idle_pct.train``, falls back to the reader of the name without
its last part (``metrics/device.idle_pct.py``). Adding a cell, a
configuration or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, plus "name"
    traffic: dict         # the traffic file, plus "name"
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    with open(ROOT / cfg_entry["file"], encoding="utf-8") as f:
        config = {**json.load(f), "name": cfg_entry["name"]}
    traffic = load_traffic(entry["traffic"])
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json", encoding="utf-8") as f:
        return {**json.load(f), "name": name}


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def metric_path(name: str) -> Path:
    """``metrics/<name>.py``, else that of ``name`` without its last
    dotted part, the reader every split of a metric by cell shares."""
    path = PKG / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = PKG / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of the metric's reader (``metric_path``): the
    metric's value, or None where the run gave it nothing to read."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
