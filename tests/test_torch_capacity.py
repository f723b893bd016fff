"""The port's capacity search, ledger and merge
(``gpuaudiobench_tpu_torch/tools/{capacity,build_capacity_ledger,
merge_capacity}.py``) and its buffer-64 attribution
(``tools/overlap64_attrib.py``) against the reference's ``tools/``
copies, on the CPU.

* ``search_capacity`` makes the reference's probes, in order, on
  hypothesis-generated monotone thresholds.
* With the same fake probe, ``main`` writes the reference's record, and
  ``render_md`` the reference's text but for one more column, ``flag``,
  which fires exactly when the device p50 exceeds the saturated p50.
* ``classify_wall`` reads torch's allocation failures as "memory" and
  any other CUDA error as "device", which stops the search.
* The knobs: the reference's quanta, FDTD3D's ceiling the port's
  largest room, PartConv's derived from its ``memory_report``.
* overlap64's best tier is a measured one, even where the record's
  deadline is its smallest value.
"""

import argparse
import copy
import json
import os
import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.tools import (
    build_capacity_ledger,
    capacity,
    merge_capacity,
    overlap64_attrib,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import build_capacity_ledger as ref_ledger  # noqa: E402
import capacity as ref  # noqa: E402

CPU = torch.device("cpu")
CUDA_OOM = ("OutOfMemoryError: CUDA out of memory. Tried to allocate "
            "2.00 GiB. GPU 0 has a total capacity of 79.19 GiB")


@settings(max_examples=200, deadline=None)
@given(lo_q=st.integers(1, 8), span_q=st.integers(0, 600),
       quantum=st.sampled_from([1, 2, 128, 1024]),
       threshold=st.integers(-10, 700_000), max_evals=st.integers(1, 30))
def test_search_makes_the_reference_probes(lo_q, span_q, quantum, threshold,
                                           max_evals):
    lo, hi = lo_q * quantum, (lo_q + span_q) * quantum

    def oracle(v):
        return v <= threshold

    assert capacity.search_capacity(oracle, lo, hi, quantum, max_evals) == \
        ref.search_capacity(oracle, lo, hi, quantum, max_evals)


@pytest.mark.parametrize("lo,hi,quantum", [(100, 1024, 128), (128, 1000, 128),
                                           (256, 128, 128)])
def test_search_refuses_the_reference_bounds(lo, hi, quantum):
    with pytest.raises(ValueError) as ours:
        capacity.search_capacity(lambda v: True, lo, hi, quantum, 5)
    with pytest.raises(ValueError) as theirs:
        ref.search_capacity(lambda v: True, lo, hi, quantum, 5)
    assert str(ours.value) == str(theirs.value)


def _fake_probe(scenario):
    """A probe for both tools: the detail dicts of the reference's."""
    def make(benchmark, field, args, device_timing=False):
        def evaluate(v):
            if scenario == "memory" and v > 256:
                raise RuntimeError(CUDA_OOM)
            if scenario == "error" and v > 256:
                raise ValueError("something else entirely")
            limit = {"deadline": 256, "memory": 10**9, "error": 10**9,
                     "ceiling": 10**9, "below": 0, "budget": 10**9,
                     "gap": 5000}[scenario]
            p99 = 0.1 if v <= limit else 99.0
            dev = 0.3 if scenario == "deadline" else 0.05
            return p99 <= 10.667, {
                "value": v, "saturated_p50_ms": 0.2 if p99 < 1 else p99,
                "saturated_p99_ms": p99, "valid": True,
                "device_p50_ms": dev if device_timing else None,
                "device_method": "cuda-events" if device_timing else None}
        return evaluate
    return make


SCENARIOS = {
    "deadline": ["--lo", "128", "--hi", "1024", "--quantum", "128"],
    "memory": ["--lo", "128", "--hi", "1024", "--quantum", "128"],
    "error": ["--lo", "128", "--hi", "1024", "--quantum", "128"],
    "ceiling": ["--lo", "128", "--hi", "1024", "--quantum", "128"],
    "below": ["--lo", "128", "--hi", "1024", "--quantum", "128"],
    "budget": ["--lo", "128", "--hi", "1 << 20", "--quantum", "128",
               "--maxEvals", "3"],
    "gap": ["--lo", "128", "--hi", "65536", "--quantum", "128",
            "--maxEvals", "7"],
}


def _records(tmp_path, monkeypatch, scenario, extra=()):
    argv = [a if a != "1 << 20" else str(1 << 20)
            for a in SCENARIOS[scenario]]
    out = {}
    for tag, mod in (("ours", capacity), ("theirs", ref)):
        monkeypatch.setattr(mod, "harness_probe", _fake_probe(scenario))
        path = tmp_path / f"{tag}.json"
        rc = mod.main(["--benchmark", "gain", *argv, *extra,
                       "--json", str(path)])
        out[tag] = (rc, json.loads(path.read_text()))
    return out


def _drop_flag(text: str) -> str:
    """The markdown without its last column: the reference's table."""
    lines = []
    for ln in text.splitlines():
        if ln.startswith("|"):
            ln = ln[:ln.rstrip().rstrip("|").rstrip().rindex("|") + 1]
        lines.append(ln)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_main_writes_the_reference_record_and_table(tmp_path, monkeypatch,
                                                    scenario):
    got = _records(tmp_path, monkeypatch, scenario)
    assert got["ours"] == got["theirs"]
    rec = got["ours"][1]
    ours, theirs = capacity.render_md([rec]), ref.render_md([rec])
    assert "| flag |" in ours
    assert _drop_flag(ours) == theirs
    flagged = capacity.DEVICE_OVER_SATURATED in ours
    c = rec.get("confirmation") or {}
    assert flagged == (c.get("device_p50_ms") is not None
                       and c["device_p50_ms"] > c["saturated_p50_ms"])


def test_confirm_only_writes_the_reference_record(tmp_path, monkeypatch):
    got = _records(tmp_path, monkeypatch, "deadline",
                   extra=["--confirmOnly", "128,256,384"])
    assert got["ours"] == got["theirs"]
    assert got["ours"][0] == 1  # 384 misses


@given(dev=st.one_of(st.none(), st.floats(0, 20, allow_nan=False)),
       sat=st.one_of(st.none(), st.floats(0, 20, allow_nan=False)))
def test_flag_fires_exactly_when_device_exceeds_saturated(dev, sat):
    conf = {"device_p50_ms": dev, "saturated_p50_ms": sat,
            "saturated_p99_ms": sat}
    rec = {"benchmark": "gain", "knob": "n_tracks", "capacity": 256,
           "ceiling_hit": False, "deadline_ms": 10.667, "buffer_size": 512,
           "fs": 48000, "confirmation": conf}
    want = dev is not None and sat is not None and dev > sat
    assert capacity.device_over_saturated(conf) == want
    row = capacity.render_md([rec]).splitlines()[-1]
    assert row.endswith(f"| {capacity.DEVICE_OVER_SATURATED} |" if want
                        else "|  |")
    assert _drop_flag(capacity.render_md([rec])) == ref.render_md([rec])


@pytest.mark.parametrize("text,wall", [
    (CUDA_OOM, "memory"),
    ("RuntimeError: dwg_block_launch failed: CUDA error 2", "memory"),
    ("RuntimeError: CUDA error: out of memory", "memory"),
    ("AcceleratorError: CUDA error: an illegal memory access was "
     "encountered", "device"),
    ("RuntimeError: CUDA error: device-side assert triggered", "device"),
    ("RuntimeError: fdtd3d_field failed: CUDA error 700", "device"),
    ("RuntimeError: iir_biquad_launch failed: CUDA error 20", "device"),
    ("ValueError: fdtd_room must be in [8, 128], got 130", "error"),
    # The reference's relay wall has no counterpart on the card.
    ("INTERNAL: http://x/remote_compile: HTTP 413: length limit exceeded",
     "error"),
])
def test_classify_wall_reads_torch_errors(text, wall):
    assert capacity.classify_wall(text) == wall


def test_a_sticky_cuda_error_stops_the_search(tmp_path, monkeypatch):
    seen = []

    def fake(benchmark, field, args, device_timing=False):
        def evaluate(v):
            seen.append((v, device_timing))
            if v > 256:
                raise RuntimeError("fdtd3d_field failed: CUDA error 700")
            return True, {"value": v, "saturated_p50_ms": 0.1,
                          "saturated_p99_ms": 0.1, "valid": True,
                          "device_p50_ms": None, "device_method": None}
        return evaluate

    monkeypatch.setattr(capacity, "harness_probe", fake)
    out = tmp_path / "cap.json"
    rc = capacity.main(["--benchmark", "gain", "--lo", "128", "--hi",
                        "4096", "--quantum", "128", "--json", str(out),
                        "--md", str(tmp_path / "cap.md")])
    assert rc == 1
    rec = json.loads(out.read_text())
    assert seen == [(128, False), (256, False), (512, False)]  # no more
    assert "CUDA error 700" in rec["stopped"]
    assert rec["capacity"] == 256 and rec["confirmation"] is None
    assert rec["wall_class"] == "device" and rec["budget_exhausted"]
    assert rec["probes"][-1]["wall_class"] == "device"
    assert "device wall" in (tmp_path / "cap.md").read_text()


def test_memory_wall_is_a_miss_and_the_search_goes_on(tmp_path, monkeypatch):
    got = _records(tmp_path, monkeypatch, "memory")
    rec = got["ours"][1]
    assert rec["capacity"] == 256 and rec["wall_class"] == "memory"
    assert len(rec["probes"]) > 3


def test_knobs_keep_the_quanta_and_take_the_cards_ceilings():
    for name, (field, lo, hi, q) in capacity.KNOBS.items():
        assert (field, q) == ref.KNOBS[name][::3], name
        assert lo == ref.KNOBS[name][1]
    assert capacity.TRACK_KNOB == ref.TRACK_KNOB
    assert capacity.EXCLUDED == ref.EXCLUDED
    room = capacity.KNOBS["FDTD3D"][2]
    BenchConfig(fdtd_room=room).validate()
    with pytest.raises(ValueError):
        BenchConfig(fdtd_room=room + 2).validate()


def test_partconv_ceiling_is_derived_from_memory_report():
    """80 GB over the largest resident bytes a track of the three forms
    at the 1 s IR (memory_report), on the quantum."""
    per_track = {}
    for form in ("shift", "ring", "nupols"):
        cfg = BenchConfig(n_tracks=128, ir_length=48000, partconv_form=form,
                          verification="none", device_timing=False)
        b = create_benchmark("PartConv", cfg, CPU)
        b.setup()
        per_track[form] = b.memory_report()["totalBytes"] / 128
    assert per_track == {"shift": 779_744, "ring": 1_165_520,
                         "nupols": 1_352_120}
    field, lo, hi, q = capacity.KNOBS["PartConv"]
    assert hi == int(80e9 // max(per_track.values())) // q * q


def test_parse_overrides_checks_the_ports_config():
    assert capacity.parse_overrides(
        ["fdtd_per_track_receivers=true", "fdtd_room=64",
         "partconv_form=ring", "dawsim_jitter_us=2.5",
         "modal_num_modes=4096"]) == {
        "fdtd_per_track_receivers": True, "fdtd_room": 64,
        "partconv_form": "ring", "dawsim_jitter_us": 2.5,
        "modal_num_modes": 4096}
    with pytest.raises(SystemExit,
                       match="unknown BenchConfig field 'compilation_cache'"):
        capacity.parse_overrides(["compilation_cache=false"])
    with pytest.raises(SystemExit):
        capacity.parse_overrides(["fdtd_room"])


def test_end_to_end_gain_on_the_cpu(tmp_path):
    # fs 1000: a 512 ms deadline, which a CPU under load still meets (the
    # test is of the path, not of the CPU's speed).
    out, md = tmp_path / "cap.json", tmp_path / "cap.md"
    rc = capacity.main([
        "--benchmark", "gain", "--device", "cpu", "--lo", "128", "--hi",
        "256", "--quantum", "128", "--nRuns", "2", "--warmup", "1",
        "--pipelineDepth", "8", "--satReps", "3", "--verification",
        "spot", "--fs", "1000", "--json", str(out), "--md", str(md)])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["capacity"] == 256 and rec["ceiling_hit"]
    assert rec["confirmation"]["valid"]
    assert "| gain | n_tracks | 256 |" in md.read_text()
    assert not os.path.exists(str(out) + ".partial")


def test_the_card_is_the_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        capacity.main(["--benchmark", "gain", "--lo", "128", "--hi", "128",
                       "--quantum", "128"])


def _search_and_confirm():
    base = {"benchmark": "FDTD3D", "knob": "fdtd_room", "capacity": 108,
            "ceiling_hit": False, "budget_exhausted": False,
            "boundary_gap": 2, "deadline_ms": 10.667, "margin": 0.0,
            "buffer_size": 512, "fs": 48000, "pipeline_depth": 8,
            "saturated_reps": 5,
            "config_overrides": {"fdtd_per_track_receivers": True},
            "wall_class": "deadline", "probes": []}
    conf = {"benchmark": "FDTD3D", "knob": "fdtd_room", "kind": "confirm",
            "deadline_ms": 10.667, "buffer_size": 512, "fs": 48000,
            "pipeline_depth": 8, "saturated_reps": 5,
            "config_overrides": {"fdtd_per_track_receivers": True},
            "confirms": [
                {"value": 106, "saturated_p50_ms": 10.0,
                 "saturated_p99_ms": 10.1, "device_p50_ms": 10.2,
                 "device_method": "cuda-events", "sustains": True},
                {"value": 108, "saturated_p50_ms": 10.7,
                 "saturated_p99_ms": 10.8, "device_p50_ms": 10.5,
                 "device_method": "cuda-events", "sustains": False}]}
    return base, conf


@pytest.mark.parametrize("with_search", [True, False])
def test_ledger_is_the_references_with_the_flag(with_search):
    search, conf = _search_and_confirm()
    s = search if with_search else None
    ours = build_capacity_ledger.build(copy.deepcopy(s), copy.deepcopy(conf))
    theirs = ref_ledger.build(copy.deepcopy(s), copy.deepcopy(conf))
    flag = ours.pop("device_over_saturated")
    assert ours == theirs
    # The certified point (106) reads 10.2 ms on the device against a
    # saturated 10.0: flagged.
    assert ours["capacity"] == 106 and flag is True


def test_merge_groups_by_deadline_and_renders_the_flag(tmp_path):
    search, conf = _search_and_confirm()
    rec = build_capacity_ledger.build(search, conf)
    other = dict(rec, buffer_size=64, benchmark="gain")
    paths = []
    for i, r in enumerate((rec, other)):
        p = tmp_path / f"r{i}.json"
        p.write_text(json.dumps(r))
        paths.append(str(p))
    out = tmp_path / "merged.md"
    assert merge_capacity.main([str(out), *paths,
                                str(tmp_path / "missing.json")]) == 0
    text = out.read_text()
    assert text.count("# Real-time capacity") == 2
    assert text.count(capacity.DEVICE_OVER_SATURATED) == 2


def test_overlap64_best_tier_is_never_the_deadline():
    rec = {"benchmark": "gain", "deadline_ms": 0.001, "upload_only_ms": 0.0005,
           "dispatch_only_ms": 0.0004, "serial_ms": 0.0003,
           "overlapped_ms": 0.05, "overlapped_deep_ms": 0.04,
           "batched_8_ms": None, "batched_32_ms": 0.03}
    assert overlap64_attrib.best_tier(rec) == ("batched_32", 0.03)
    assert "deadline" not in overlap64_attrib.MEASURED_TIERS
    assert overlap64_attrib.best_tier({"deadline_ms": 1.0}) is None


def test_overlap64_runs_on_the_cpu(tmp_path):
    out = str(tmp_path / "o64")
    assert overlap64_attrib.main([out, "--reps", "2", "--workloads",
                                  "gain", "--device", "cpu"]) == 0
    (row,) = json.load(open(out + ".json"))["rows"]
    assert row["best_tier"] in overlap64_attrib.MEASURED_TIERS
    assert row["best_ms"] == row[row["best_tier"] + "_ms"]
    assert overlap64_attrib.COMPONENTS == (
        "upload_only_ms", "dispatch_only_ms", "serial_ms", "overlapped_ms",
        "overlapped_deep_ms", "batched_8_ms", "batched_32_ms")
    for k in overlap64_attrib.COMPONENTS:
        assert row[k] > 0, k
    text = open(out + ".md").read()
    assert "| gain |" in text and "(cpu)" in text


def test_overlap64_fails_on_a_batched_tier_that_raises(tmp_path,
                                                      monkeypatch):
    """A batched tier that raises is recorded and makes the run exit 1,
    though the other tiers were measured."""
    from gpuaudiobench_tpu_torch.harness import overlap

    def broken(*a, **k):
        raise RuntimeError("batched upload failed")

    monkeypatch.setattr(overlap, "measure_overlap_batched", broken)
    out = str(tmp_path / "o64")
    assert overlap64_attrib.main([out, "--reps", "2", "--workloads",
                                  "gain", "--device", "cpu"]) == 1
    (row,) = json.load(open(out + ".json"))["rows"]
    assert row["batched_8_ms"] is None and row["batched_32_ms"] is None
    assert row["batched_8_error"] == "RuntimeError: batched upload failed"
    assert row["best_tier"] in ("overlapped", "overlapped_deep")


def test_harness_probe_reads_the_ports_result(tmp_path):
    args = argparse.Namespace(
        device="cpu", fs=1000, bufferSize=64, nRuns=2, warmup=1,
        pipelineDepth=8, satReps=3, verification="spot", margin=0.0, set=[])
    ok, d = capacity.harness_probe("gain", "n_tracks", args,
                                   device_timing=True)(16)
    assert ok and d["valid"] and d["value"] == 16
    assert d["device_method"] == "wall"
    assert set(d) == {"value", "saturated_p50_ms", "saturated_p99_ms",
                      "valid", "device_p50_ms", "device_method"}
