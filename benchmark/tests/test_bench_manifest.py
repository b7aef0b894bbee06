"""``BENCHMARK.json`` and the files it names: every cell resolves to its
configuration, mix, driver, limits and metric readers, and the manifest
keeps the shape its readers expect: keys, names, units and bounds."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.Cell(cell)
    assert c.kind in ("train", "serve")
    assert c.driver().run
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.chips in (1, 4)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in names


def test_configs():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_four_chip_cells_at_most_a_quarter():
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_roofline_has_a_step_share_beside_it():
    """A kernel's roofline moving an end-to-end metric stands beside a
    whole-step share of the peak that moves the same metric."""
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_driver_reports_the_cells_end_to_end_metrics(cell):
    c = harness.Cell(cell)
    reported = {"train": {"train_img_per_s", "setup_s"},
                "serve": {"serve_img_per_s", "serve_p95_ms", "setup_s"}}[c.kind]
    assert {m["name"] for m in c.end_to_end} <= reported
