"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell is found by."""

import json
import re
from pathlib import Path

import pytest

from portbench import drivers, harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = MANIFEST["configs"] + MANIFEST["workloads"] + MANIFEST["end_to_end"] \
        + MANIFEST["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in MANIFEST["workloads"]:
        assert ONE_LINE.match(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MANIFEST["configs"]:
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
    for m in MANIFEST["per_layer"]:
        assert ONE_LINE.match(m["layer"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_config_has_a_cell_and_every_cell_one_chip():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_reports_its_metrics(cell):
    """Every cell reports ``setup_s``, another end-to-end metric that its
    driver measures, and a per-layer metric; every per-layer metric of the
    cell moves a metric the cell reports and has its reader."""
    files = harness.cell_files(MANIFEST, cell)
    names = {m["name"] for m in files.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    driver = drivers.DRIVERS[files.mix["driver"]]
    assert names - {"setup_s"} <= set(driver.metrics)
    assert files.per_layer
    listed = [m for m in MANIFEST["per_layer"] if cell in m.get("workloads", [cell])]
    for m in listed:
        assert m["moves"] in names, (m["name"], m["moves"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    assert set(files.limits) and all(v >= 0 for v in files.limits.values())


def test_per_layer_workloads_exist_and_layers_name_alike():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_config_files_under_paths_and_reduced_empty():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("portbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] == []
        assert body["source"] == c["source"]


def test_checks_fit_the_run_budget():
    rs = MANIFEST["run_seconds"]
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
