"""The port's results tools: ``analysis/compare.py`` (its published
tables equal the repo-level file's, which the web UI now reads from the
port's copy), ``tools/compare_runs.py`` (the root tool's verdicts on the
same pair of files), ``tools/report.py`` (every row and the card) and
``tools/doctor.py`` (healthy on the CPU, prompt on a wedged probe)."""

import contextlib
import copy
import importlib.util
import io
import json
import os
import sys
import time

import pytest

from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.analysis import compare
from gpuaudiobench_tpu_torch.tools import compare_runs, doctor, report
from gpuaudiobench_tpu_torch.utils.published import published_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = {"kind": "NVIDIA H100 80GB HBM3", "platform": "gpu",
        "timing_environment": "local", "power_limit": "700.00 W"}


def _load(rel, name):
    tools_dir = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools_dir)  # the root tools import _pathfix
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools_dir)
    return mod


def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a, **kw)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def port_json(tmp_path_factory):
    """A JSON array of the port's CLI: three benchmarks on the CPU."""
    path = str(tmp_path_factory.mktemp("runs") / "r.json")
    rc, out = _quiet(cli.main, [
        "--benchmarkFilter", "=NoOp,=gain,=ModalFilterBank", "--nTracks", "8",
        "--bufferSize", "64", "--nRuns", "4", "--pipelineDepth", "4",
        "--saturatedReps", "3", "--json", "--quiet", "--outputfile", path],
        device="cpu")
    assert rc == 0, out
    with open(path) as f:
        return json.load(f)


# -- analysis/compare.py ------------------------------------------------------

def test_published_tables_equal_the_root_files():
    root = _load("analysis/compare.py", "root_compare")
    assert compare.PUBLISHED == root.PUBLISHED
    assert compare.NOTES == root.NOTES
    # The root file's sweep also carries its TPU column, which the port
    # does not copy.
    assert compare.MODAL_SWEEP == {
        m: {k: v for k, v in row.items() if k in ("PC", "AS")}
        for m, row in root.MODAL_SWEEP.items()}
    tables = published_tables()
    assert tables["published"] is compare.PUBLISHED
    assert tables["notes"] is compare.NOTES
    assert tables["modal_sweep"] is compare.MODAL_SWEEP


def test_published_module_reads_no_file_by_path():
    from gpuaudiobench_tpu_torch.utils import published

    src = open(published.__file__).read()
    assert "importlib" not in src and "os.path" not in src


def test_compare_labels_the_card(tmp_path, port_json):
    data = [dict(r, device=CARD) for r in port_json]
    path = tmp_path / "gpu.json"
    path.write_text(json.dumps(data))
    rows, card = compare.load_rows(str(path))
    assert card == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert [r["benchmark"] for r in rows] == ["NoOp", "gain",
                                              "ModalFilterBank"]
    rc, out = _quiet(compare.main, [str(path)])
    assert rc == 0
    assert "port: NVIDIA H100 80GB HBM3, 700.00 W" in out
    assert "TPU" not in out and "v5e" not in out
    assert "published = 1M modes" in out


def test_compare_reads_the_ports_csv(tmp_path):
    path = str(tmp_path / "r.csv")
    rc, out = _quiet(cli.main, ["--benchmark", "NoOp", "--nTracks", "8",
                                "--bufferSize", "64", "--nRuns", "3",
                                "--outputfile", path], device="cpu")
    assert rc == 0, out
    rows, card = compare.load_rows(path)
    assert card == compare.CSV_CARD
    assert rows[0]["benchmark"] == "NoOp" and rows[0]["p50_ms"] > 0
    rc, out = _quiet(compare.main, [path])
    assert rc == 0 and "NoOp" in out


# -- tools/compare_runs.py ----------------------------------------------------

def _variant(records, device_scale=1.0, sat_scale=1.0, rt_scale=1.0,
             cv=None, tracks=None, drop=None):
    out = []
    for r in copy.deepcopy(records):
        if r["benchmark"] == drop:
            continue
        if r.get("device_statistics"):
            r["device_statistics"]["median_ms"] *= device_scale
        if (r.get("saturated") or {}).get("p50_ms"):
            r["saturated"]["p50_ms"] *= sat_scale
            if cv is not None:
                r["saturated"]["cv_percent"] = cv
        r["statistics"]["p50_ms"] *= rt_scale
        if cv is not None:
            r["statistics"]["cv_percent"] = cv
        if tracks is not None and r["benchmark"] == "gain":
            r["configuration"]["nTracks"] = tracks
        out.append(r)
    return out


CASES = {
    "same": ({}, {}),
    "device regressed": ({"cv": 1.0}, {"device_scale": 1.5, "cv": 1.0}),
    "wall drift": ({"cv": 1.0}, {"sat_scale": 1.2, "cv": 1.0}),
    "wall drift past the ceiling": ({"cv": 1.0},
                                    {"sat_scale": 1.4, "cv": 1.0}),
    "improved": ({"cv": 1.0}, {"device_scale": 0.5, "sat_scale": 0.5,
                               "rt_scale": 0.5, "cv": 1.0}),
    "config mismatch and missing": ({}, {"tracks": 16, "drop": "NoOp"}),
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_runs_verdicts_equal_the_root_tools(tmp_path, port_json,
                                                    case, strict):
    root = _load("tools/compare_runs.py", "root_compare_runs")
    old_kw, new_kw = CASES[case]
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(_variant(port_json, **old_kw)))
    new.write_text(json.dumps(_variant(port_json, **new_kw)))
    got = compare_runs.compare(str(old), str(new), 5.0, strict_wall=strict)
    want = root.compare(str(old), str(new), 5.0, strict_wall=strict)
    assert got == want
    argv = [str(old), str(new)] + (["--strict-wall"] if strict else [])
    rc, out = _quiet(compare_runs.main, argv)
    assert rc == root.main(argv) == (1 if got[1] else 0)
    assert "old: cpu; new: cpu" in out


def test_compare_runs_waivers_as_the_root_tool(tmp_path, port_json):
    root = _load("tools/compare_runs.py", "root_compare_runs")
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(_variant(port_json, cv=1.0)))
    new.write_text(json.dumps(_variant(port_json, device_scale=1.5,
                                       cv=1.0)))
    _, gating = compare_runs.compare(str(old), str(new))
    waive = [f"--waive={n}:{t}:investigated" for n, t, _ in gating]
    rc, out = _quiet(compare_runs.main, [str(old), str(new)] + waive)
    assert rc == root.main([str(old), str(new)] + waive) == 0
    assert "waived: investigated" in out
    stale = ["--waive", "NoOp:saturated:nothing gates"]
    rc, out = _quiet(compare_runs.main, [str(old), str(new)] + stale)
    assert rc == 2 and "unconsumed waiver" in out
    rc, out = _quiet(compare_runs.main, [str(old), str(new), "--waive", "x"])
    assert rc == 2


# -- tools/report.py ----------------------------------------------------------

def test_report_holds_every_row_and_the_card(tmp_path, port_json):
    data = [dict(r, device=CARD) for r in port_json]
    src, html_out = tmp_path / "r.json", tmp_path / "r.html"
    src.write_text(json.dumps(data))
    rc, out = _quiet(report.main, [str(src), "-o", str(html_out)])
    assert rc == 0 and "3 benchmarks" in out
    page = html_out.read_text()
    for r in data:
        assert f"<td>{r['benchmark']}</td>" in page
        assert f"<h3>{r['benchmark']}</h3>" in page
        assert f"{r['statistics']['p50_ms']:.3f}" in page
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in page
    assert "vs published baselines" in page and "RTX 4070 p50" in page
    assert "<svg" in page
    assert "TPU" not in page and "v5e" not in page
    # One object, not an array.
    src.write_text(json.dumps(data[0]))
    rc, out = _quiet(report.main, [str(src), "-o", str(html_out)])
    assert rc == 0 and "1 benchmarks" in out


# -- tools/doctor.py ----------------------------------------------------------

def test_doctor_healthy_on_the_cpu():
    rc, out = _quiet(doctor.main, ["--device", "cpu",
                                   "--probe-timeout", "120"])
    assert rc == 0, out
    assert "[+] device" in out and "cpu (torch" in out
    assert "doctor: healthy" in out
    assert "[x]" not in out
    assert "native pacer" in out and "peak calibration" in out


def test_doctor_reports_a_wedged_probe_without_hanging():
    t0 = time.perf_counter()
    rc, out = _quiet(doctor.main, ["--device", "cpu",
                                   "--probe-timeout", "0.05"])
    assert time.perf_counter() - t0 < 60
    assert rc == 1
    assert "[x] device" in out and "no answer in 0.05 s" in out
    assert "wedged" in out and "NOT healthy" in out


def test_doctor_fails_without_cuda_when_asked_for_the_card(monkeypatch):
    monkeypatch.setattr(doctor, "PROBE", dict(
        doctor.PROBE, cuda="raise SystemExit('no CUDA device')"))
    rc, out = _quiet(doctor.main, ["--probe-timeout", "120"])
    assert rc == 1 and "[x] device" in out
