"""The port's span recorder (``harness/profiler.py``: ``PerformanceProfiler``
grown into the process's ``SPANS``), the spans at the program's own
boundaries (``gpuab.iterate``, ``gpuab.op``, ``gpuab.d2h``, ``gpuab.h2d``),
the ``--capture`` trace's summary over a phase with its idle gaps named by
those spans, and the benchmark's readers of them (``rtbench/metrics/``) on
hand-made traces and records. All on the CPU; the chain graph's replay
counter is tested on the card (``tests/test_torch_cuda.py``)."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpuaudiobench_tpu_torch.config import BenchConfig  # noqa: E402
from gpuaudiobench_tpu_torch.harness import graph, profiler  # noqa: E402
from gpuaudiobench_tpu_torch.ops import gpuab, rndmem  # noqa: E402
from gpuaudiobench_tpu_torch.registry import create_benchmark  # noqa: E402
from gpuaudiobench_tpu_torch.utils import device as dev  # noqa: E402
from rtbench import spec  # noqa: E402
from rtbench.trace import TraceView  # noqa: E402

CPU = torch.device("cpu")
SpanRecord = profiler.SpanRecord


@pytest.fixture
def spans():
    """The process's recorder, emptied, and off again after the test."""
    profiler.SPANS.reset()
    profiler.disable()
    yield profiler.SPANS
    profiler.disable()
    profiler.SPANS.reset()


def test_off_records_nothing(spans):
    assert profiler.span("gpuab.op") is profiler.span("gpuab.d2h")
    with profiler.span("gpuab.iterate"):
        with profiler.span("gpuab.op"):
            pass
    dev.from_device(torch.ones(4))
    assert spans.records() == [] and spans.summary() == {}


def test_on_records_nesting_parents_roots_and_self_time(spans):
    profiler.enable()
    for _ in range(2):
        with profiler.span("gpuab.iterate"):
            with profiler.span("gpuab.op"):
                with profiler.span("inner"):
                    pass
            dev.from_device(torch.ones(4))
    profiler.disable()
    with profiler.span("gpuab.iterate"):
        pass
    recs = spans.records()
    assert [r.name for r in recs] == ["inner", "gpuab.op", "gpuab.d2h",
                                      "gpuab.iterate"] * 2
    trees = spans.trees()
    assert len(trees) == 2 and spans.trees(1) == trees[1:]
    for root, inside in trees:
        assert root.parent == 0 and root.root == root.serial
        by_name = {r.name: r for r in inside}
        assert set(by_name) == {"inner", "gpuab.op", "gpuab.d2h"}
        assert all(r.root == root.serial for r in inside)
        assert by_name["gpuab.op"].parent == root.serial
        assert by_name["gpuab.d2h"].parent == root.serial
        assert by_name["inner"].parent == by_name["gpuab.op"].serial
        for r in (root, *inside):
            assert r.end_ns >= r.start_ns
        kids = [r for r in inside if r.parent == root.serial]
        assert kids[0].start_ns >= root.start_ns
        assert kids[-1].end_ns <= root.end_ns
        own = profiler.self_ns(root, inside)
        assert own + sum(k.end_ns - k.start_ns for k in kids) == (
            root.end_ns - root.start_ns)
        assert profiler.self_ns(root, inside, ["gpuab.op"]) == own + (
            by_name["gpuab.d2h"].end_ns - by_name["gpuab.d2h"].start_ns)
    assert trees[0][0].root != trees[1][0].root
    assert spans.summary()["gpuab.iterate"]["count"] == 2


def test_the_ring_drops_the_oldest_and_counts_it():
    rec = profiler.PerformanceProfiler(capacity=4)
    rec.enabled = True
    for i in range(6):
        with rec.span(f"s{i}"):
            pass
    assert [r.name for r in rec.records()] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2
    assert [r.name for r, _ in rec.trees(2)] == ["s4", "s5"]
    rec.reset()
    assert rec.records() == [] and rec.dropped == 0


def test_a_span_is_a_profiler_range_of_its_name(spans):
    from torch.profiler import ProfilerActivity, profile

    assert not spans.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("gpuab.iterate"):
            dev.from_device(torch.ones(8) * 2)
    names = [e.name for e in prof.events()]
    assert "gpuab.iterate" in names and "gpuab.d2h" in names
    assert [r.name for r in spans.records()] == ["gpuab.d2h", "gpuab.iterate"]
    with profiler.span("gpuab.iterate"):  # the session is over: off again
        pass
    assert len(spans.records()) == 2


class _Gather(torch.nn.Module):
    def forward(self, pool, heads):
        return rndmem.rndmem_gather(pool, heads, 16)


def test_spans_are_off_while_a_program_is_exported(spans):
    gpuab.load()
    pool = torch.arange(256, dtype=torch.float32)
    heads = torch.tensor([0, 7, 100, 200], dtype=torch.int32)
    profiler.enable()
    try:
        prog = torch.export.export(_Gather(), (pool, heads))
    finally:
        profiler.disable()
    assert spans.records() == []
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert any("gpuab.rndmem_gather_launch" in t for t in targets)
    assert not any("profiler" in t for t in targets)
    assert torch.equal(prog.module()(pool, heads),
                       rndmem.rndmem_gather_plain(pool, heads, 16))


TINY = dict(n_tracks=8, buffer_size=64, n_runs=3, warmup=1, modal_num_modes=256,
            write_latencies=False, device_timing=False, verification="none")


@pytest.mark.parametrize("name", ["NoOp", "gain", "GainStats", "IIRFilter",
                                  "ModalFilterBank", "RndMemRead"])
def test_each_iterate_opens_one_root(spans, name):
    cfg = BenchConfig(**{**TINY, "rndmem_pool_mb": 1})
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    spans.reset()
    profiler.enable()
    for _ in range(3):
        b.iterate()
    profiler.disable()
    trees = spans.trees()
    assert [r.name for r, _ in trees] == ["gpuab.iterate"] * 3
    assert len({r.serial for r, _ in trees}) == 3
    for root, inside in trees:
        assert all(c.name.startswith("gpuab.") for c in inside)
        assert "gpuab.iterate" not in {c.name for c in inside}


# --- the --capture trace, summarized over a phase -------------------------


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_takes_idle_over_the_phase_and_names_gaps(tmp_path):
    events = [
        _ev("user_annotation", "timed", 100.0, 100.0),
        _ev("user_annotation", "gpuab.iterate", 102.0, 90.0),
        _ev("user_annotation", "gpuab.op", 104.0, 6.0),
        _ev("user_annotation", "gpuab.d2h", 150.0, 40.0),
        _ev("gpu_user_annotation", "gpuab.op", 110.0, 30.0),
        _ev("kernel", "k", 90.0, 5.0),       # before the phase
        _ev("kernel", "k", 112.0, 30.0),     # 112 - 142
        _ev("gpu_memcpy", "Memcpy DtoH", 170.0, 4.0),  # 170 - 174
        _ev("cpu_op", "aten::add", 120.0, 1.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiler.trace_summary(str(path), 2, "timed")
    assert s["kernel_us_per_block"] == {"k": 15.0, "Memcpy DtoH": 2.0}
    assert s["device_busy_us_per_block"] == 17.0
    assert s["window_us_per_block"] == 50.0
    assert s["device_idle_share"] == pytest.approx(66.0 / 100.0)
    # Gaps 100-112 (middle 106, inside gpuab.op), 142-170 (middle 156,
    # gpuab.d2h), 174-200 (middle 187, gpuab.d2h); split at each range's
    # edge: 2 outside every range, 2 + 2 in the root alone, 6 in the
    # operator; 8 in the root, 20 in the copy; 16 in the copy, 2 in the
    # root, 8 outside.
    assert s["idle_gaps"] == [("gpuab.d2h", 28.0), ("gpuab.d2h", 26.0),
                              ("gpuab.op", 12.0)]
    assert s["idle_us_per_block_by_range"] == {
        "": 5.0, "gpuab.iterate": 7.0, "gpuab.op": 3.0, "gpuab.d2h": 18.0}
    whole = profiler.trace_summary(str(path), 1)
    assert whole["window_us_per_block"] == 84.0  # first to last event
    assert whole["idle_us_per_block_by_range"] == {
        "": 7.0, "gpuab.iterate": 12.0, "gpuab.op": 6.0, "gpuab.d2h": 20.0}
    with pytest.raises(ValueError, match="saturated"):
        profiler.trace_summary(str(path), 1, "saturated")


def test_summarize_names_a_gap_outside_every_range_by_nothing():
    s = profiler.summarize([("k", 0.0, 10.0), ("k", 20.0, 30.0)], 1,
                           window=(0.0, 40.0),
                           ranges=[("gpuab.iterate", 5.0, 18.0)])
    assert s["device_idle_share"] == 0.5
    assert s["idle_gaps"] == [("gpuab.iterate", 10.0), ("", 10.0)]
    assert s["idle_us_per_block_by_range"] == {"gpuab.iterate": 8.0,
                                               "": 12.0}


# --- the benchmark's readers of the spans ---------------------------------


def _reader(name):
    return spec.load_module("metrics", name)


def _view(kind, callbacks, events=()):
    spans = {"rtbench.window": [(0.0, 10_000.0)]}
    if callbacks:
        spans["rtbench.callback"] = list(callbacks)
    return TraceView(kind=kind, config={}, device_name="card",
                     events=list(events), spans=spans, blocks=1,
                     units=max(1, len(callbacks)), measured={})


def _callbacks(monkeypatch):
    """Three callbacks' spans: each root 198.5 us, an operator call of 10,
    11 and 12 us and a copy back of 179 us less that."""
    rec = profiler.PerformanceProfiler()
    monkeypatch.setattr(profiler, "SPANS", rec)
    ranges = []
    for k in range(3):
        lo, hi = 1000.0 * k + 100.0, 1000.0 * k + 300.0
        a, op, s = int((lo + 1.0) * 1000), (10 + k) * 1000, 10 * k + 1
        rec._write(SpanRecord("gpuab.op", a + 2000, a + 2000 + op, s + 1, s,
                              s))
        rec._write(SpanRecord("gpuab.d2h", a + 3000 + op, a + 182_000, s + 2,
                              s, s))
        rec._write(SpanRecord("gpuab.iterate", a, a + 198_500, s, 0, s))
        ranges.append((lo, hi))
    return _view("callback", ranges)


def test_callback_readers_split_the_root(monkeypatch):
    view = _callbacks(monkeypatch)
    assert _reader("callback_dispatch_us").read(view) == pytest.approx(11.0)
    # 198.5 us less the operator call and the copy (179 us less the call).
    assert _reader("callback_wrapper_us").read(view) == pytest.approx(
        198.5 - 179.0)


def test_callback_readers_need_every_traced_root(monkeypatch):
    names = ("callback_wrapper_us", "callback_dispatch_us")
    view = _callbacks(monkeypatch)
    view.spans["rtbench.callback"].append((5000.0, 5200.0))  # one more
    assert [_reader(n).read(view) for n in names] == [None] * 2
    monkeypatch.setattr(profiler, "SPANS", profiler.PerformanceProfiler())
    assert [_reader(n).read(_view("callback", [(0.0, 9.0)]))
            for n in names] == [None] * 2
    monkeypatch.delattr(profiler, "SPANS")  # a program without the recorder
    assert [_reader(n).read(_view("callback", [(0.0, 9.0)]))
            for n in names] == [None] * 2
    assert [_reader(n).read(_view("stream", [])) for n in names] == [None] * 2


def test_graph_nodes_per_block_reads_the_one_continuing_chain(monkeypatch):
    read = _reader("graph_nodes_per_block").read
    chains = {"other": [{"depth": 4, "nodes": 30, "continuing": False}]}
    monkeypatch.setattr(graph, "CHAINS", chains)
    assert read(_view("stream", [])) is None  # the loop: no continuing chain
    chains["cell"] = [{"depth": 512, "nodes": 2563, "continuing": True}]
    assert read(_view("stream", [])) == 2563 / 512
    assert read(_view("callback", [(0.0, 1.0)])) is None
    chains["cell"].append({"depth": 512, "nodes": 2563, "continuing": True})
    assert read(_view("stream", [])) is None
    monkeypatch.delattr(graph, "CHAINS")
    assert read(_view("stream", [])) is None


def test_the_benchmark_declares_the_span_metrics():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("callback_wrapper_us", "callback_dispatch_us"):
        assert per_layer[name]["workloads"] == ["modal_1m.callback"]
        assert per_layer[name]["moves"] == "roundtrip_p50_ms"
    assert per_layer["graph_nodes_per_block"]["workloads"] == [
        "modal_1m.stream", "rndmem_65536.stream"]
    for name in per_layer:
        assert callable(_reader(name).read)


def test_span_cost_reads_the_modal_round_trip(spans):
    from gpuaudiobench_tpu_torch.tools import span_cost

    res = span_cost.measure(256, 8, 64, callbacks=6, rounds=2, device=CPU)
    assert set(res["empty_span_ns"]) == {"off", "on"}
    assert set(res["drained_us"]) == {"gpuab.d2h"}  # the CPU runs the twin
    for setting in ("off", "on", "traced"):
        assert res[setting]["roundtrip_p50_us"] > 0
    for setting in ("on", "traced"):
        got = res[setting]["spans_us"]
        assert 0 < got["wrapper"] < got["gpuab.iterate"]
        assert 0 < got["gpuab.d2h"] < got["gpuab.iterate"]
        assert got["gpuab.op"] == 0.0  # no operator call on the CPU
        assert res[setting]["self_plus_children_gap_us"] < 1.0
    assert not spans.enabled and spans.records() == []
