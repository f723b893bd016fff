"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""

from __future__ import annotations

import json
import re

import pytest

from rtbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_uniqueness():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        for w in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert w in CELLS and w in reports, (m["name"], w)


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_resolves_and_reports(cell_name):
    cell = spec.Cell(BENCH, cell_name)
    assert cell.chips in (1, 4)
    assert cell.config["name"] == cell.entry["config"]
    assert callable(cell.generator().drive)
    assert len(cell.entry["why"]) <= 200
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for entry, reader in cell.readers():
        assert callable(reader.read), entry["name"]
    assert callable(cell.reference().make_inputs)
    check = cell.check()
    assert check.ITEM in check.LIMITS
    for fn in ("judge", "control"):
        assert callable(getattr(check, fn)), fn
    spec.load_module("cost", cell.config["kernel"])


def test_configs_files_and_sources():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("rtbench/configs/")
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["source"] == c["source"]
        assert conf["name"] == c["name"]
        assert len(c["reduced"]) <= 16


def test_traffic_files_are_data():
    for w in BENCH["workloads"]:
        path = spec.HERE / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(path.read_text())
        assert (spec.HERE / "generators" / f"{mix['kind']}.py").is_file()
        assert set(mix["small"]) <= set(mix), w["traffic"]
