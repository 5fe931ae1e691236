"""BENCHMARK.json against the shape a run and its checks require, and
every file it names found by name."""

import json
import os
import re

import pytest

from benchmark.harness import manifest as mf

ROOT = mf.Manifest.__init__.__globals__["BENCH"].rsplit(os.sep, 1)[0]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in bench["configs"]]
                 + [w["why"] for w in bench["workloads"]]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_what_it_must(bench):
    manifest = mf.Manifest(ROOT)
    for w in bench["workloads"]:
        ends = [m["name"] for m in manifest.end_to_end(w)]
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        layers = manifest.per_layer(w)
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in ends, (w["name"], m["name"])


def test_every_file_is_found_by_name(bench):
    manifest = mf.Manifest(ROOT)
    metrics = mf.metric_files()
    for w in bench["workloads"]:
        config = manifest.config(w)
        assert config["name"] == w["config"]
        traffic = mf.traffic(w["traffic"])
        assert mf.entry(traffic["entry"]) is not None
        assert mf.limits(w["name"])
        for m in manifest.per_layer(w):
            assert m["name"] in metrics
            assert callable(mf.reader(m["name"]))


def test_configs_hold_their_sources_keys(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert set(config["reduced"]) <= set(config["source_values"])
        assert config["dtype"] == "float32" and config["tf32"] is False


def test_a_full_check_fits_its_time(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = (runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200)
    assert total <= 43200
