"""The saturated chain's two forms (harness/streaming.py, harness/graph.py)
and the profiler capture (harness/profiler.py, ``--capture``) on the CPU.

The CUDA graph itself runs only on the card (tests/test_torch_cuda.py);
here: the loop form, the entry-carry rule the graph keeps, which bodies
are declared capturable, the launch tally a capture records, and the
trace a ``capture`` run writes.
"""

import dataclasses
import json
import tempfile

import pytest
import torch

from gpuaudiobench_tpu.harness import profiler as jax_profiler
from gpuaudiobench_tpu_torch import registry
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import graph, profiler, streaming
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models.gain import GainBenchmark

CPU = torch.device("cpu")
TOY = dict(n_tracks=8, buffer_size=64, n_runs=3, warmup=1,
           write_latencies=False, device_timing=False)


def _inplace_step(carry):
    """A body that writes its carry in place (as PartConv's ring and the
    DWG rails do) and advances a Python int beside it."""
    x, head = carry
    x.mul_(2.0).add_(head)
    return (x, head + 1), x.sum().reshape(1)


def test_loop_keeps_its_probes_and_carry():
    """The loop form is ``run_chained`` on the caller's carry: probes
    stacked in order, and the same carry objects handed to every run, so
    an in-place body goes on from where the last run ended while its
    Python int restarts."""
    x = torch.ones(4)
    probes = streaming.run_chained(_inplace_step, (x, 0), 3)
    assert probes.tolist() == [8.0, 20.0, 48.0]  # x: 2, 5, 12
    assert x.tolist() == [12.0] * 4
    again = streaming.run_chained(_inplace_step, (x, 0), 3)
    assert again.tolist() == [96.0, 196.0, 400.0]  # from 12, not from 1

    x = torch.ones(4)
    (lat,) = streaming.measure_saturated_multi(
        _inplace_step, (x, 0), [2], reps=3, form="loop")
    assert len(lat) == 3 and all(v > 0 for v in lat)
    # The warm run and 3 reps, each x -> 2x + 0 -> 2x + 1 from where the
    # last ended: 1 -> 5 -> 21 -> 85 -> 341.
    assert x[0].item() == 341.0


def test_entry_carry_rule_gives_equal_reps():
    """The rule each graph replay keeps: a rep that starts from a clone of
    the entry carry gives the probes of the first rep, whatever the body
    writes in place; the Python int goes through its depth steps from its
    entry value."""
    entry = (torch.ones(4), 0)
    reps = []
    for _ in range(3):
        fresh = graph.clone_carry(entry)
        reps.append(streaming.run_chained(_inplace_step, fresh, 3))
    assert all(torch.equal(r, reps[0]) for r in reps)
    assert reps[0].tolist() == [8.0, 20.0, 48.0]
    assert entry[0].tolist() == [1.0] * 4  # the entry is never written


def test_carry_tensors_and_rebuild_keep_the_structure():
    a, b, c = torch.zeros(2), torch.ones(3), torch.full((1,), 5.0)
    carry = (a, (b, 7, None), [c, "ring"])
    ts = graph._tensors(carry)
    assert [t is u for t, u in zip(ts, (a, b, c))] == [True] * 3
    new = [t + 1 for t in ts]
    it = iter(new)
    out = graph.rebuild(carry, iter([next(it) if isinstance(x, torch.Tensor)
                                     else x for x in graph.leaves(carry)]))
    assert out[1][1:] == (7, None) and out[2][1] == "ring"
    assert isinstance(out[2], list)
    assert out[0] is new[0] and out[1][0] is new[1] and out[2][0] is new[2]
    assert graph._tensors(a) == [a]


def test_chain_graph_needs_a_cuda_carry():
    with pytest.raises(ValueError, match="CUDA"):
        graph.ChainGraph(_inplace_step, (torch.ones(4), 0), 3, name="toy")


def test_chain_form_and_chains_on_the_cpu():
    cuda = torch.device("cuda:0")  # a descriptor: no GPU needed
    assert streaming.chain_form(cuda, True) == "cuda-graph"
    assert streaming.chain_form(cuda, False) == "loop"
    assert streaming.chain_form(CPU, True) == "loop"
    x = torch.ones(4)
    lo, hi = streaming.chains(_inplace_step, (x, 0), [1, 2], "loop")
    assert lo().tolist() == [8.0] and hi().tolist() == [16.0, 36.0]
    with pytest.raises(ValueError, match="chain form"):
        streaming.chains(_inplace_step, (x, 0), [1], "scan")


def test_count_launch_records_under_a_capture():
    """Outside a capture a launch goes to its wrapper's count; inside one
    to the chain's tally, which each replay adds to REPLAYED_LAUNCHES."""
    counts = {"k": 0}
    graph.count_launch(counts, "k")
    assert counts == {"k": 1}
    tally = {"k": 0}
    graph._RECORDING.append(tally)
    try:
        graph.count_launch(counts, "k")
        graph.count_launch(counts, "k")
    finally:
        graph._RECORDING.pop()
    assert counts == {"k": 1} and tally == {"k": 2}


@pytest.mark.parametrize("name", [n for n in registry.ported_benchmarks()
                                  if not n.startswith("datacopy")])
def test_every_stream_body_but_the_lstm_is_capturable(name):
    b = registry.create_benchmark(name, BenchConfig(**TOY), CPU)
    assert b.stream_capturable is (name != "NeuralAmpLSTM")


def _gain(cfg):
    b = GainBenchmark(cfg, CPU)
    b.setup()
    return b


def _fields(res):
    """The result fields a run filled (a non-empty list, a set value)."""
    out = set()
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if v not in (None, [], {}, 0, 0.0, ""):
            out.add(f.name)
    return out


def test_capture_writes_a_trace_and_the_same_result(tmp_path):
    cfg = BenchConfig(pipeline_depth=8, saturated_reps=2, overlap_depth=2,
                      overlap_reps=1, **TOY)
    plain = run_benchmark(_gain(cfg), cfg, verbose=False)
    ccfg = cfg.replace(capture=True, capture_dir=str(tmp_path / "t"))
    got = run_benchmark(_gain(ccfg), ccfg, verbose=False)
    assert _fields(got) == _fields(plain)
    assert set(got.metadata) == set(plain.metadata)
    assert got.metadata["chainForm"] == plain.metadata["chainForm"] == "loop"
    assert got.validation.passed
    path = tmp_path / "t" / "gain.trace.json"
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"warmup", "timed", "saturated", "saturated-reps", "overlap",
            "validate"} <= names
    for phase in ("saturated", "saturated-reps"):
        assert profiler.trace_events(str(path), phase) == []  # no device
    with pytest.raises(ValueError, match="device-timing"):
        profiler.trace_events(str(path), "device-timing")


def test_no_chain_form_without_a_saturated_tier():
    cfg = BenchConfig(**TOY)
    res = run_benchmark(_gain(cfg), cfg, verbose=False)
    assert "chainForm" not in res.metadata


def test_trace_dir_defaults_under_the_temp_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert profiler.trace_dir("") == str(tmp_path / "tpuaudiobench_trace")
    assert profiler.trace_dir("elsewhere") == "elsewhere"
    assert BenchConfig().capture_dir == ""


def test_trace_events_keeps_the_phase_window(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "saturated",
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 90.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 110.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 140.0,
         "dur": 8.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 120.0,
         "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 148.0, "dur": 5.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiler.trace_events(str(path), "saturated") == [
        ("k", 110.0, 115.0), ("Memcpy DtoH", 140.0, 148.0)]
    assert len(profiler.trace_events(str(path))) == 4
    s = profiler.summarize(profiler.trace_events(str(path), "saturated"), 2)
    assert s["device_busy_us_per_block"] == 6.5
    assert s["device_idle_share"] == pytest.approx(25.0 / 38.0)


def test_capture_trace_on_the_cpu_writes_json(tmp_path, capsys):
    with profiler.capture_trace(str(tmp_path / "d"), CPU, "toy") as path:
        torch.ones(8).sum()
    assert json.loads((tmp_path / "d" / "toy.trace.json").read_text())
    assert path == str(tmp_path / "d" / "toy.trace.json")
    assert f"Profiler trace written to {path}" in capsys.readouterr().out


def test_performance_profiler_matches_the_reference(capsys):
    ours, ref = profiler.PerformanceProfiler(), jax_profiler.PerformanceProfiler()
    samples = [("upload", 0.0021), ("kernel", 0.0105), ("upload", 0.0019),
               ("readback", 0.004), ("kernel", 0.0099)]
    for label, sec in samples:
        ours.record(label, sec)
        ref.record(label, sec)
    assert ours.summary() == ref.summary()
    ours.print_summary()
    mine = capsys.readouterr().out
    ref.print_summary()
    assert mine == capsys.readouterr().out
    with ours.measure("span"):
        pass
    assert ours.summary()["span"]["count"] == 1
    ours.reset()
    assert ours.summary() == {}
