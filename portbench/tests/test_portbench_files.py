"""BENCHMARK.json against the contract it is written to, and every cell,
configuration and metric found by name under portbench/."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names_use_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").exists()
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        mover = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(
            mover.get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    wl, cfg = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] == cfg["name"]
    assert wl["traffic"] == entry["traffic"]
    assert (ROOT / "portbench" / "entries" / f"{wl['entry']}.py").exists()
    assert (ROOT / "portbench" / "reference"
            / f"{cfg['reference']}.py").exists()
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200
    assert float(wl["limits"]["metric_gap"]) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = [n for n, _ in harness.metric_names(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metric_names(BENCH, cell, "per_layer")


def test_configs_have_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and c["reduced"] == []
        assert data["source"] == c["source"]
