"""A cell's files, found by the names in ``BENCHMARK.json``.

* ``configs/<config>.json``: the configuration's sizes and settings;
  ``configs/<config>.program.py`` builds it from the program and
  ``configs/<config>.reference.py`` from the plain reference;
* ``traffic/<traffic>.json``: the mix, read by the driver it names
  (``harness/drivers/<driver>.py``, a module of the package);
* ``limits/<cell>.json``: the limit of each number the comparison makes;
* ``metrics/<metric>.py``: the reader of a per-layer metric;
* ``roofline/<kernel>.py``: a kernel's operations and bytes.

A later cell, mix, configuration or metric is a new file, and no file here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file ``path`` as a module of its own (file names here
    hold dots and dashes, so they are loaded by path)."""
    name = "benchmark_file_" + re.sub(r"\W", "_", os.path.relpath(path, HERE))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def part(kind: str, name: str, suffix: str) -> str:
    return os.path.join(HERE, kind, name + suffix)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # this cell's end-to-end metrics
    per_layer: list      # this cell's per-layer metrics

    def program(self):
        return load_module(part("configs", self.config_name, ".program.py"))

    def reference(self):
        return load_module(part("configs", self.config_name,
                                ".reference.py"))

    def driver(self):
        return importlib.import_module("benchmark.harness.drivers."
                                       + self.traffic["driver"])


def metric_in(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: it lists the cell, or it lists
    none and moves an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, benchmark: str = None) -> Cell:
    bench = read_json(benchmark or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = read_json(part("configs", cell["config"], ".json"))
    traffic = read_json(part("traffic", cell["traffic"], ".json"))
    limits = read_json(part("limits", name, ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if metric_in(m, name, reported)]
    return Cell(name, cell["chips"], cell["config"], config, traffic, limits,
                e2e, layer)
