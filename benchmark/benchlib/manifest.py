"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells (``workloads``) and the metrics.  Everything that belongs to one
of them sits in a file of its own, found by name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
  the file names the system that builds it (``systems/<system>.py``) and
  its plain reference (``reference/<reference>.py``);
* a traffic mix: ``traffic/<traffic>.json``;
* a per-layer metric: ``metrics/<name>.py``, a reader with
  ``read(run) -> float | None``; a dot in the name is a folder
  (``metrics/device/idle_pct.py``).

So a later cell, mix or metric is a new file and a new entry, and no file
here changes.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    entry: dict
    config: dict
    config_entry: dict
    traffic: dict
    end_to_end: list
    per_layer: list


class Manifest:
    def __init__(self, path=None):
        self.path = Path(path) if path else ROOT / "BENCHMARK.json"
        self.data = load_json(self.path)
        self.root = self.path.parent

    def workload_names(self):
        return [w["name"] for w in self.data["workloads"]]

    def config_entry(self, name):
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def config(self, name):
        return load_json(self.root / self.config_entry(name)["file"])

    def traffic(self, name):
        return load_json(BENCH_DIR / "traffic" / f"{name}.json")

    @staticmethod
    def _applies(metric, workload):
        return "workloads" not in metric or workload in metric["workloads"]

    def cell(self, workload):
        for entry in self.data["workloads"]:
            if entry["name"] == workload:
                break
        else:
            raise KeyError(f"no workload {workload!r} in {self.path}")
        return Cell(
            name=workload, chips=int(entry["chips"]), entry=entry,
            config=self.config(entry["config"]),
            config_entry=self.config_entry(entry["config"]),
            traffic=self.traffic(entry["traffic"]),
            end_to_end=[m for m in self.data["end_to_end"]
                        if self._applies(m, workload)],
            per_layer=[m for m in self.data["per_layer"]
                       if self._applies(m, workload)])


def load(kind, name):
    """The module ``<kind>.<name>``: ``systems``, ``reference``, ``tables``
    or ``metrics`` (whose ``read(run)`` is a metric's reader), from the
    benchmark's folder on ``sys.path``."""
    return importlib.import_module(f"{kind}.{name}")
