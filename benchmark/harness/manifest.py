"""`BENCHMARK.json` and the files it names, found by name:

  * a configuration `<config>` in `benchmark/configs/<config>.json`;
  * a traffic mix `<mix>` in `benchmark/traffic/<mix>.json`, whose
    `"entry"` names the module of `benchmark/harness/entries/` that drives
    the program;
  * a per-layer metric `<metric>` in `benchmark/metrics/<metric>.py`,
    whose `read(ctx)` returns its value or None;
  * a cell's limits in `benchmark/limits/<cell>.json`.

Nothing here knows a particular configuration, mix or metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: str):
        self.root = root
        self.data = _json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(self.cells)}")
        return self.cells[name]

    def _applies(self, metric: dict, cell: dict) -> bool:
        return cell["name"] in metric.get("workloads", [cell["name"]])

    def end_to_end(self, cell: dict) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: dict) -> List[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"]
                     if c["name"] == cell["config"])
        return _json(os.path.join(self.root, entry["file"]))


def traffic(name: str, bench: str = BENCH) -> dict:
    return _json(os.path.join(bench, "traffic", f"{name}.json"))


def limits(cell_name: str, bench: str = BENCH) -> dict:
    return _json(os.path.join(bench, "limits", f"{cell_name}.json"))


def entry(name: str):
    """The `Entry` class of `benchmark/harness/entries/<name>.py`."""
    if not re.fullmatch(r"[a-z_][a-z0-9_]*", name):
        raise ValueError(f"bad entry name {name!r}")
    return importlib.import_module(f"benchmark.harness.entries.{name}").Entry


def reader(metric: str, bench: str = BENCH) -> Callable:
    """`read` of `benchmark/metrics/<metric>.py` (metric names hold dots,
    so the file is loaded by path)."""
    path = os.path.join(bench, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_files(bench: str = BENCH) -> Dict[str, str]:
    """Every per-layer metric file, by metric name."""
    d = os.path.join(bench, "metrics")
    return {f[:-3]: os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".py") and not f.startswith("_")}
