"""BENCHMARK.json against the contract it is written to, and every entry
resolved to its files."""
import json
import math
import re

import pytest

from benchmark import check, run, spec

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "-m", "benchmark.run"]


def test_run_seconds_fit_24_cells():
    s = MANIFEST["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = spec.load(run.ROOT, workload)
    assert cell.chips == 1
    assert cell.traffic["kind"] in ("rig", "backlog")
    assert cell.config["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                       if w["name"] == workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert all(callable(r) for r in spec.readers(cell).values())
    lim = check.limits(workload)
    assert set(lim) <= set(check.SERVE_NUMBERS) and all(0 < v < math.inf for v in lim.values())


def test_per_layer_moves_reported_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in CELLS
            assert w in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("benchmark/configs/")
    body = json.loads((run.ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert config["reduced"] == []
