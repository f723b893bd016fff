"""What the benchmark loads, and the shape of its result line."""

from __future__ import annotations

import json
import subprocess
import sys

from rtbench import run, spec
from rtbench.tests.conftest import CELLS, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "gpuaudiobench_tpu")


def _loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    probe = (code + "\nimport sys, json\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                               "HOME": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_run_and_its_parts_load_no_jax_nor_the_jax_package():
    names = _loaded_after(
        "import rtbench.run, rtbench.harness, rtbench.control, rtbench.trace\n"
        "from rtbench import spec\n"
        "b = spec.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = spec.Cell(b, w['name']); c.reference(); c.readers()\n"
        "    c.generator(); c.check(); c.faults()\n"
        "    spec.load_module('cost', c.config['kernel'])\n"
        "import gpuaudiobench_tpu_torch.registry as r; r._factories()\n")
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "gpuaudiobench_tpu_torch" in names  # the port itself is loaded


def test_references_load_nothing_of_the_program():
    names = _loaded_after(
        "from rtbench import spec\n"
        "b = spec.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = spec.Cell(b, w['name']); c.reference(); c.check()\n")
    assert not names & set(FORBIDDEN + ("gpuaudiobench_tpu_torch",))


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpuaudiobench_tpu_torch_like", sys)
    assert "gpuaudiobench_tpu" not in run.foreign_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert run.foreign_modules() == ["jaxlib"]


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _out() -> dict:
    out = {"correct": True, "attempted": 10, "failed": 0,
           "memory_peak_bytes": 123, "setup_s": 4.5, "block_ms": 0.12,
           "roundtrip_p50_ms": 0.18, "roundtrip_p95_ms": 0.2,
           "numbers": {"a": 1e-6}, "limits": {"a": 1e-3}}
    events = [("modal_bank_kernel<12, 4>", 10.0, 60.0),
              ("Memcpy DtoH (Device -> Pinned)", 61.0, 62.0),
              ("modal_bank_kernel<12, 4>", 70.0, 120.0),
              ("Memcpy DtoH (Device -> Pageable)", 121.0, 122.0)]
    spans = {"rtbench.window": [(0.0, 130.0)],
             "rtbench.replay": [(1.0, 9.0), (62.0, 69.0)],
             "rtbench.callback": [(1.0, 62.5), (65.0, 125.0)]}
    out["trace"] = (events, spans, 2, 2)
    out["measured"] = {"window_us": 1e6, "units": 8000, "unit_p50_us": 120.0,
                       "blocks": 8000}
    return out


def test_result_line_keys_follow_the_contract():
    bench = spec.load_benchmark()
    for name in CELLS:
        cell = spec.Cell(bench, name)
        line = run.result_line(cell, _out(), False, "NVIDIA H100 80GB HBM3", 1)
        assert list(line) == ["correct", "attempted", "failed", "metrics",
                              "device", "checks"]
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert set(line["device"]) == {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        traced = run.result_line(cell, _out(), True, "NVIDIA H100 80GB HBM3", 1)
        assert list(traced)[-1] == "checks"
        assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert traced["metrics"]
        assert {"busy_s", "window_s"} <= set(traced["device"])
        assert traced["device"]["busy_s"] > 0
        for part in ("device_ops", "idle_gaps"):
            assert len(traced["breakdown"][part]) <= 10
        json.dumps(traced)
