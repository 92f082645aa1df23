"""Everything a run looks up by name: the cell in BENCHMARK.json, its
configuration and traffic files, and the metric readers.

A cell `<config>.<traffic>` names configs/<config>.json (through
BENCHMARK.json's `configs`) and traffic/<traffic>.json; the traffic names
its entry module, entries/<entry>.py; each metric is metrics/<name>.py with a
`read(rec)` that returns a number or None. Adding a cell, a traffic mix or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads, with its files read."""

    def __init__(self, name, root=ROOT):
        self.bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise ValueError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg = {c["name"]: c for c in self.bench["configs"]}[
            self.workload["config"]]
        self.config_entry = cfg
        self.config = _load_json(os.path.join(root, cfg["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = _load_json(os.path.join(
            BENCH_DIR, "traffic", f"{self.traffic_name}.json"))

    def scene_path(self):
        return os.path.join(BENCH_DIR, self.config["scene"])

    def metrics(self, trace):
        """The cell's end-to-end metrics (trace false) or per-layer ones
        (trace true): each entry of BENCHMARK.json whose workloads list
        this cell, or that has no list."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def entry(self):
        return _module(os.path.join(BENCH_DIR, "entries",
                                    f"{self.traffic['entry']}.py"),
                       f"bench_entry_{self.traffic['entry']}")


def reader(name):
    """metrics/<name>.py's read function."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    return _module(path, "bench_metric_" + name.replace(".", "_")).read
