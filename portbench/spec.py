"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``BENCHMARK.json``'s ``configs`` entry and its ``file``,
  ``portbench/configs/<config>.json``;
- a cell: its ``workloads`` entry and its traffic mix,
  ``portbench/workloads/<traffic>.json``;
- a metric: its ``end_to_end`` or ``per_layer`` entry and its reader,
  ``portbench/metrics/<metric>.py``.

A later cell, configuration or metric is new files and new entries; nothing
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent  # the checkout: BENCHMARK.json and the program
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"invalid name {name!r}")
    return name


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]  # the cells that report it; None: every cell
    moves: Optional[str]  # a per-layer metric's end-to-end metric
    root: Path

    def reader(self):
        """The metric's reader module, ``portbench/metrics/<name>.py``."""
        path = self.root / "portbench" / "metrics" / f"{self.name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{self.name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic mix's contents
    end_to_end: List[Metric]  # the end-to-end metrics this cell reports
    per_layer: List[Metric]  # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics(bench: dict, kind: str, root: Path = ROOT) -> List[Metric]:
    """The ``end_to_end`` or ``per_layer`` metrics of ``BENCHMARK.json``."""
    return [Metric(name=check_name(m["name"]), unit=m["unit"], workloads=m.get("workloads"),
                   moves=m.get("moves"), root=root) for m in bench[kind]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "workloads" / f"{check_name(entry['traffic'])}.json").read_text())
    end_to_end = metrics(bench, "end_to_end", root)
    per_layer = metrics(bench, "per_layer", root)
    reports_e2e = [m for m in end_to_end if m.workloads is None or name in m.workloads]
    reported = {m.name for m in reports_e2e}
    # a per-layer metric without "workloads" is read in every cell that
    # reports the end-to-end metric it moves
    reports_layer = [
        m for m in per_layer
        if (name in m.workloads if m.workloads is not None else m.moves in reported)
    ]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                end_to_end=reports_e2e, per_layer=reports_layer)
