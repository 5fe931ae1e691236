"""A new configuration, traffic mix or per-layer metric is taken by name,
with no edit to a file that is there."""

import json
import os
import shutil

from benchmark.harness import cli
from benchmark.harness import manifest as mf

BENCH = mf.BENCH


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), root)
    return str(root), str(root / "benchmark")


def _contents(bench):
    out = {}
    for dp, _, fs in os.walk(bench):
        for f in fs:
            path = os.path.join(dp, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, bench)] = fh.read()
    return out


def test_new_files_are_picked_up(tmp_path):
    root, bench = _copy(tmp_path)
    before = _contents(bench)
    with open(os.path.join(bench, "traffic", "tick_base.json")) as f:
        mix = json.load(f)
    mix["batch"] = 32
    with open(os.path.join(bench, "traffic", "tick_b32.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "ticks_run.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.units.get('ticks')\n")
    with open(os.path.join(bench, "limits", "all_1728.tick_b32.json"),
              "w") as f:
        json.dump({"base_score_gap": 1.0}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        data = json.load(f)
    data["workloads"].append({"name": "all_1728.tick_b32",
                              "config": "all_1728", "traffic": "tick_b32",
                              "chips": 1, "why": "BASE ticks of 32"})
    data["per_layer"].append({"name": "ticks_run", "unit": "ticks",
                              "better": "higher", "source": "host_clock",
                              "layer": "streaming tick",
                              "moves": "tick_p95_ms",
                              "workloads": ["all_1728.tick_b32"]})
    for m in data["end_to_end"]:
        if m["name"] == "tick_p95_ms":
            m["workloads"].append("all_1728.tick_b32")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)

    manifest = mf.Manifest(root)
    cell = manifest.cell("all_1728.tick_b32")
    assert mf.traffic(cell["traffic"], bench)["batch"] == 32
    assert mf.limits(cell["name"], bench) == {"base_score_gap": 1.0}
    assert "ticks_run" in mf.metric_files(bench)
    assert [m["name"] for m in manifest.per_layer(cell)] == ["ticks_run"]
    ctx = cli.Readings({}, {}, None, {"ticks": 7}, {})
    assert mf.reader("ticks_run", bench)(ctx) == 7
    after = _contents(bench)
    assert {p: after[p] for p in before} == before
