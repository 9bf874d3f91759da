"""BENCHMARK.json against the benchmark's contract: keys, names and units,
files found by name, metrics reported where they move something."""

import json
import re

import pytest
from conftest import BENCH, ROOT

from vdbbench import harness, system

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = {}
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in SPEC[kind]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and _line(e["why"])
            names.setdefault(kind, []).append(e["name"])
    for c in SPEC["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(SPEC["paths"][0] + "/")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for group in (names["configs"], names["workloads"], [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_and_reports_enough(cell):
    w = harness.cell_of(SPEC, cell)
    config = harness.config_of(SPEC, ROOT, w["config"])
    traffic = harness.traffic_of(w, BENCH)
    assert config["name"] == w["config"] and traffic["entry"] in system.ENTRIES
    e2e = [m["name"] for m in harness.metrics_for(SPEC, cell, False)]
    layers = harness.metrics_for(SPEC, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])
    for name in e2e:
        assert callable(harness.reader("e2e", name, BENCH))
    for m in layers:
        assert callable(harness.reader("layers", m["name"], BENCH))


def test_metric_workloads_name_cells():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
