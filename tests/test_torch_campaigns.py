"""The port's poster-table campaigns (tab4-tab8, the low-latency sweep and
the high-rep saturated percentiles) on the CPU at toy sizes: each
produces its rows and its markdown through ``main(argv, device="cpu")``,
and keeps the JAX tools' published numbers and points."""

import importlib.util
import json
import os
import sys

import pytest

from gpuaudiobench_tpu_torch.analysis import compare
from gpuaudiobench_tpu_torch.tools import (
    dawsim_campaign,
    lowlatency_sweep,
    modal_sweep,
    rndmem_sweep,
    satreps_campaign,
    transfer_tab5,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    """A repo-level tool of the JAX package, loaded by path (each imports
    ``_pathfix`` as a sibling)."""
    tools_dir = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools_dir)
    try:
        spec = importlib.util.spec_from_file_location(
            f"root_{name}", os.path.join(tools_dir, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools_dir)
    return mod


def _payload(base):
    with open(base + ".json") as f:
        payload = json.load(f)
    with open(base + ".md") as f:
        return payload, f.read()


# -- tab4 -------------------------------------------------------------------

def test_modal_sweep_points_are_tab4():
    assert [p[0] for p in modal_sweep.POINTS] == [1024, 102400, 1048576]
    for modes, _, pc, as_ in modal_sweep.POINTS:
        assert (pc, as_) == (compare.MODAL_SWEEP[modes]["PC"][0],
                             compare.MODAL_SWEEP[modes]["AS"][0])
    assert modal_sweep.N_TRACKS == 1024


def test_modal_sweep_toy(tmp_path, monkeypatch):
    monkeypatch.setattr(modal_sweep, "POINTS",
                        [(1024, 4, 0.050, 0.172), (2048, 4, 0.315, 0.611)])
    monkeypatch.setattr(modal_sweep, "N_TRACKS", 32)
    base = str(tmp_path / "tab4")
    assert modal_sweep.main([base + ".md", "--nRuns", "2", "--satReps", "2"],
                            device="cpu") == 0
    payload, md = _payload(base)
    assert payload["card"] == "cpu"
    assert [r["modes"] for r in payload["rows"]] == [1024, 2048]
    for r in payload["rows"]:
        assert r["validation"] == "passed"
        assert r["roundtrip_p50_ms"] > 0 and r["saturated_p50_ms"] > 0
    assert "tab4) on cpu" in md and "| 2048 | 0.315 | 0.611 |" in md


# -- tab6 -------------------------------------------------------------------

def test_rndmem_sweep_covers_all_published_sizes():
    assert [p[0] for p in rndmem_sweep.POINTS] == [32, 128, 1024, 4096,
                                                   16384, 65536]
    root = _root_tool("rndmem_sweep")
    assert [p[2:] for p in rndmem_sweep.POINTS] == [p[2:]
                                                    for p in root.POINTS]
    assert rndmem_sweep.POOL_MIB == 512


def test_rndmem_sweep_toy(tmp_path, monkeypatch):
    monkeypatch.setattr(rndmem_sweep, "POINTS",
                        [(2, 4, 0.138, 0.229), (64, 2, 0.364, 0.723)])
    monkeypatch.setattr(rndmem_sweep, "POOL_MIB", 1)
    base = str(tmp_path / "tab6")
    assert rndmem_sweep.main([base, "--nRuns", "2", "--satReps", "2"],
                             device="cpu") == 0
    payload, md = _payload(base)
    assert payload["pool_mib"] == 1
    assert [(r["tracks"], r["depth"]) for r in payload["rows"]] == [
        (2, 4), (64, 2)]
    assert all(r["validation"] == "passed" for r in payload["rows"])
    assert "(tab6, 1 MiB pool) on cpu" in md
    assert "| 64 | 0.364 | 0.723 |" in md and "/2 sizes" in md


# -- tab5 -------------------------------------------------------------------

def test_tab5_baselines_are_the_jax_tools():
    assert transfer_tab5.TAB5_BASELINES == \
        _root_tool("transfer_tab5").TAB5_BASELINES


def test_tab5_render_handles_rows_and_errors():
    payload = {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W", "n_runs": 3,
        "overlap_depth": 8,
        "rows": [
            {"benchmark": "datacopy0199", "mib": 100,
             "roundtrip_p50_ms": 44.4, "serial_ms": 12.0,
             "overlapped_ms": 3.0, "h2d_path": "pinned",
             "validation": "passed",
             **transfer_tab5.TAB5_BASELINES["datacopy0199"]},
            {"benchmark": "datacopy5050", "mib": 100,
             "error": "RuntimeError: boom"},
        ],
        "gib_rows": [{"benchmark": "datacopy5050", "mib": 1024,
                      "roundtrip_p50_ms": 400.0, "h2d_pinned_ms": 150.0,
                      "validation": "passed"}],
    }
    md = transfer_tab5.render_md(payload)
    assert "datacopy0199 | 10.060 | 9.140 | 0.150 | 44.4000" in md
    assert "ERROR: RuntimeError: boom" in md
    assert "1 GiB tier" in md and "| datacopy5050 | 400.00 |" in md
    assert "on NVIDIA H100 80GB HBM3, 700.00 W" in md
    assert "co-located" not in md and "relay" not in md


def test_tab5_toy(tmp_path):
    base = str(tmp_path / "tab5")
    assert transfer_tab5.main(["--mib", "1", "--nRuns", "2",
                               "--overlapDepth", "4", "--overlapReps", "2",
                               "--skip1gib", "--out", base],
                              device="cpu") == 0
    payload, md = _payload(base)
    assert [r["benchmark"] for r in payload["rows"]] == sorted(
        transfer_tab5.TAB5_BASELINES)
    for r in payload["rows"]:
        assert r["validation"] == "passed" and r["h2d_path"] == "pageable"
        assert r["serial_ms"] > 0 and r["overlapped_ms"] > 0
    assert "gib_rows" not in payload


def test_tab5_records_a_failing_row_and_exits_1(tmp_path, monkeypatch):
    real = transfer_tab5.run_json

    def flaky(name, cfg, dev):
        if name == "datacopy5050":
            raise RuntimeError("boom")
        return real(name, cfg, dev)

    monkeypatch.setattr(transfer_tab5, "run_json", flaky)
    base = str(tmp_path / "tab5")
    assert transfer_tab5.main(["--mib", "1", "--nRuns", "2",
                               "--skip1gib", "--out", base],
                              device="cpu") == 1
    payload, md = _payload(base)
    assert len(payload["rows"]) == 5
    assert "ERROR: RuntimeError: boom" in md


# -- tab7 / tab8 --------------------------------------------------------------

def test_dawsim_campaign_runs_the_poster_configurations():
    names = [(w[1], w[2]) for w in dawsim_campaign.WORKLOADS]
    assert names == [("ModalFilterBank", {"n_tracks": 1024}), ("NoOp", {}),
                     ("datacopy0199", {"transfer_mib": 100})]
    # Every workload at the default 512-sample buffer.
    assert all("buffer_size" not in w[2] for w in dawsim_campaign.WORKLOADS)


def test_dawsim_campaign_toy(tmp_path, monkeypatch):
    monkeypatch.setattr(dawsim_campaign, "WORKLOADS", [
        ("Modal", "ModalFilterBank", dict(n_tracks=8, buffer_size=64),
         (1.093, 1.283), dawsim_campaign.TAB7_PC),
        ("NoOp", "NoOp", dict(n_tracks=8, buffer_size=64), (2.74, 2.863),
         None)])
    base = str(tmp_path / "dawsim")
    assert dawsim_campaign.main([base, "--nRuns", "4"], device="cpu") == 0
    payload, md = _payload(base)
    rows = payload["rows"]
    assert [(r["workload"], r["mode"]) for r in rows] == [
        (w, m) for w in ("Modal", "NoOp") for m in ("off", "sleep", "spin")]
    for r in rows:
        assert r["validation"] == "passed"
        assert 0.0 <= r["miss_rate_percent"] <= 100.0
        assert (r["pacer"] is None) == (r["mode"] == "off")
    assert rows[0]["multiplier"] == 1.0
    assert "| Modal | off |" in md and "2.87 / 3.73 / 3.96" in md
    assert "x2.740 / x2.863" in md


# -- the low-latency sweep ----------------------------------------------------

def test_lowlatency_workloads_are_the_jax_tools_first_nine():
    root = _root_tool("lowlatency_sweep")
    assert lowlatency_sweep.WORKLOADS == root.WORKLOADS[:9]
    assert lowlatency_sweep.BUFFERS == root.BUFFERS


def test_lowlatency_sweep_toy(tmp_path, monkeypatch):
    monkeypatch.setattr(lowlatency_sweep, "WORKLOADS", [
        ("Modal", "ModalFilterBank", dict(n_tracks=8), 4),
        ("IIR", "IIRFilter", dict(n_tracks=8), 4),
        ("Conv", "Conv1D", dict(n_tracks=8, ir_length=40), 4)])
    base = str(tmp_path / "low")
    assert lowlatency_sweep.main(
        [base, "--benchmarks", "ModalFilterBank,IIRFilter", "--buffers",
         "64,128", "--nRuns", "2", "--satReps", "2"], device="cpu") == 0
    payload, md = _payload(base)
    assert [r["benchmark"] for r in payload["rows"]] == ["ModalFilterBank",
                                                         "IIRFilter"]
    for r in payload["rows"]:
        assert [c["buffer"] for c in r["cells"]] == [64, 128]
        assert all(c["validation"] == "passed" for c in r["cells"])
    assert "buf 64 (ddl 1.333) | buf 128 (ddl 2.667)" in md


def test_lowlatency_sweep_refuses_an_unknown_benchmark(capsys):
    assert lowlatency_sweep.main(["--benchmarks", "Nope"],
                                 device="cpu") == 1
    assert "no workload of Nope" in capsys.readouterr().out


# -- 101 saturated reps -------------------------------------------------------

def test_satreps_campaign_gives_a_true_p99(tmp_path):
    md, js = str(tmp_path / "s.md"), str(tmp_path / "s.json")
    assert satreps_campaign.main(
        ["101", md, js, "--benchmarks", "gain,IIRFilter", "--device", "cpu",
         "--", "--nTracks", "8", "--bufferSize", "64",
         "--pipelineDepth", "4"]) == 0
    with open(js) as f:
        results = json.load(f)
    rows = satreps_campaign.rows_of(results)
    assert [r["benchmark"] for r in rows] == ["gain", "IIRFilter"]
    for r in rows:
        assert r["reps"] == 101 and r["depth"] == 4
        assert r["p99_ms"] <= r["max_ms"]
    text = open(md).read()
    assert "at 101 reps on cpu" in text and "| IIRFilter | 101 | 4 |" in text


def test_satreps_campaign_default_list_is_the_flagship_set():
    assert satreps_campaign.BENCHMARKS == _root_tool(
        "satreps_campaign").BENCHMARKS
    argv = satreps_campaign.cli_argv(["gain"], 101, "x.json", ["--seed", "7"])
    assert argv[:2] == ["--benchmarkFilter", "=gain"]
    assert argv[-2:] == ["--seed", "7"]


@pytest.mark.parametrize("tool", [modal_sweep, rndmem_sweep, transfer_tab5,
                                  dawsim_campaign, lowlatency_sweep])
def test_campaigns_default_to_the_card_and_the_temp_dir(tool):
    import inspect
    import tempfile

    assert inspect.signature(tool.main).parameters["device"].default == "cuda"
    from gpuaudiobench_tpu_torch.tools.campaign import out_base

    assert out_base("", "x") == os.path.join(tempfile.gettempdir(), "x")
    assert "docs/" not in inspect.getsource(tool)
