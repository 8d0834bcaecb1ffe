"""BENCHMARK.json holds to the contract's shape, and every cell finds its
configuration, mix, driver, limits and metrics by name."""

import importlib
import json
import re

import pytest

from hcmbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hcmbench"]
    assert BENCH["command"] == ["python3", "hcmbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["family"] and cell.mix["driver"]
    drv = harness.driver(cell)
    assert callable(drv.run) and callable(drv.checks)
    fam = harness.family(cell)
    assert hasattr(fam, "Reference") and hasattr(fam, "port_config")
    assert cell.limits and all(v is not None for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert config["file"].startswith("hcmbench/configs/")
    assert data["reduced"] == config["reduced"] == []
    assert data["source"].startswith(config["source"].split(" ")[0])


def test_every_file_belongs_to_a_name():
    """Configs, mixes, limits and metrics on disk are all named somewhere,
    so a later PR adds files and entries, never edits."""
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    on_disk = {p.stem for p in (harness.BENCH_DIR / "metrics").glob("*.py")}
    assert names <= on_disk
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    assert mixes <= {p.stem for p in (harness.BENCH_DIR / "mixes").glob("*.json")}
    for w in BENCH["workloads"]:
        mix = json.loads((harness.BENCH_DIR / "mixes" / f"{w['traffic']}.json").read_text())
        importlib.import_module(f"hcmbench.drivers.{mix['driver']}")
