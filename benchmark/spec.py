"""What BENCHMARK.json names, found by name in files of their own: a
cell's traffic file (benchmark/workloads/<cell>.json), its
configuration's file (the `file` that BENCHMARK.json gives it), and each
per-layer metric's reader (benchmark/metrics/<metric>.py). A new cell, a
new configuration or a new metric is new files and entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its traffic, its configuration
    and the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: str = ROOT,
                 workloads_dir: str | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {', '.join(sorted(cells))})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        wdir = workloads_dir or os.path.join(HERE, "workloads")
        with open(os.path.join(wdir, f"{name}.json")) as f:
            self.traffic = json.load(f)
        if self.traffic.get("config", self.entry["config"]) != self.entry["config"]:
            raise ValueError(f"{name}: the traffic file is for {self.traffic['config']!r}, "
                             f"BENCHMARK.json pairs it with {self.entry['config']!r}")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, metrics_dir: str | None = None):
    """The `read(ctx)` function of benchmark/metrics/<name>.py."""
    path = os.path.join(metrics_dir or os.path.join(HERE, "metrics"), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
