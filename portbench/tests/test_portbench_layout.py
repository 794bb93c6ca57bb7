"""BENCHMARK.json against the harness's files and the benchmark's
contract: every cell resolves to its configuration, traffic and metric
files, names and units are well formed, bounds and run length in range."""

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


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w, config, traffic, e2e, per_layer = harness.load_cell(cell)
    assert w["chips"] == 1
    assert NAME.match(w["traffic"]) and traffic["unit"] in (
        "pass", "frame", "solve")
    assert config["app"] and config["precision"] and "reduced" in config
    assert "assumed" in config and config["guarantees"]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert callable(harness.metric_reader(m["name"]))
    for k in traffic["check"]["limits"]:
        assert k in ("pixels_changed_pct", "pixels_off_pct", "film_rel_err",
                     "image_off_pct",
                     "radiosity_err", "grid_err")


def test_names_units_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_text_fields_and_size():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    texts = [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        for e in BENCH[group]:
            extra = set(e) - want
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                       "per_layer")
                             else set()), (group, extra)


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
