"""BENCHMARK.json against the benchmark's files and its character rules:
every cell finds its configuration, traffic mix, driver, limits and metric
readers by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from wmhbench import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PKG = harness.PKG_DIR


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["wmhbench"]
    assert SPEC["command"][:3] == ["python3", "-m", "wmhbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_keep_their_keys_and_names(group, keys):
    for entry in SPEC[group]:
        assert set(entry) <= keys, (group, entry)
        assert NAME.match(entry["name"]), entry["name"]
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"], SPEC)
        assert os.path.isfile(os.path.join(PKG, "drivers", cell.driver + ".py"))
        assert harness.driver_module(cell.driver).Driver
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        units = [m for m in cell.end_to_end if m["name"] != "setup_s"]
        assert len(units) == 1 and cell.per_layer, w["name"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)


def test_config_files_hold_what_is_run():
    for c in SPEC["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("wmhbench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert {"plan", "volume_shape", "spacing", "compute_dtype", "assumed"} <= set(cfg)


def test_metrics_have_readers_and_move_a_reported_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in e2e.values())
    for m in e2e.values():
        assert callable(harness.end_to_end_reader(m))
    for m in SPEC["per_layer"]:
        assert os.path.isfile(os.path.join(PKG, "metrics", m["name"] + ".py"))
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))


def test_traffic_files_are_data():
    for w in SPEC["workloads"]:
        path = os.path.join(PKG, "traffic", w["traffic"] + ".json")
        with open(path) as f:
            assert "driver" in json.load(f)


def test_reader_of_a_missing_trace_reads_nothing():
    from types import SimpleNamespace

    ctx = SimpleNamespace(trace=None, units=0, elapsed=0.0, traced_units=0)
    for m in SPEC["per_layer"]:
        assert harness.metric_reader(m["name"])(ctx) is None, m["name"]


def test_end_to_end_reader_refuses_another_unit_or_direction():
    m = dict(next(m for m in SPEC["end_to_end"] if m["name"] != "setup_s"))
    for key, other in (("unit", "tokens/s"), ("better", "higher")):
        with pytest.raises(ValueError):
            harness.end_to_end_reader(dict(m, **{key: other}))


def test_end_to_end_readers_take_the_whole_window():
    from types import SimpleNamespace

    ctx = SimpleNamespace(window_units=4, window_s=10.0, setup_s=3.5)
    for m in SPEC["end_to_end"]:
        v = harness.end_to_end_reader(m)(ctx)
        assert v == (3.5 if m["name"] == "setup_s" else 2.5), m["name"]
