"""``--dataParallel`` through the port's CLI (``main(argv, device="cpu")``)
against the JAX CLI, and its refusals.

* One CLI run holds all 21 sharded names at ``--dataParallel 4``: the
  CLI spawns 4 gloo ranks (``parallel/launch.py:spmd``) and runs the
  whole suite on them; every name validates, and its JSON has the JAX
  CLI's keys (run in this process on the conftest's 8 CPU devices) but
  for the ones ROADMAP.md §3 documents.
* The 9 names with no data-parallel axis refuse the flag with the JAX
  package's own messages; a benchmark that declared no axis gets the
  runner's; 9 tracks over 8 ranks and datacopy's input floats get the
  divisibility message; more ranks than devices exit 1 naming the count.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from gpuaudiobench_tpu import cli as jax_cli
from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.harness.base import Benchmark as JaxBenchmark
from gpuaudiobench_tpu.harness.runner import run_benchmark as jax_run
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
SHARDED = ["NoOp", "gain", "GainStats", "datacopy0199", "datacopy2080",
           "datacopy5050", "datacopy8020", "datacopy9901", "FFT1D",
           "IIRFilter", "Conv1D", "Conv1D_accel", "ModalFilterBank",
           "DWG1DNaive", "DWG1DAccel", "RndMemRead", "BiquadChain",
           "PartConv", "NeuralAmp", "NeuralAmpLSTM", "DAWSessionMix"]
UNSHARDED = ["FDTD3D", "MultiChipSuite", "ICIBandwidth", "SOL_VPU",
             "SOL_VMEM", "SOL_HBM", "SOL_MXU_bf16", "SOL_MXU_f32",
             "SOL_MXU_int8"]
# The toy size; 25 MiB is the smallest datacopy pool whose five portions
# 4 ranks divide.
CLI_TOY = ["--nTracks", "16", "--bufferSize", "64", "--nRuns", "2",
           "--warmup", "1", "--irLength", "256", "--transferMiB", "25",
           "--poolMiB", "8", "--neuralampChannels", "16",
           "--neuralampLayers", "4", "--no-device-timing", "--json"]
DP_ARGV = (["--benchmarkFilter", ",".join(f"={n}" for n in SHARDED),
            "--dataParallel", "4"] + CLI_TOY)
# The port's keys the JAX CLI's JSON lacks, and the reverse (ROADMAP.md
# §3): the collectives a round trip issued in place of the model of the
# TPU interconnect (which the JAX package writes for DAWSessionMix only);
# with or without the flag, NeuralAmp's matmul precision and block form,
# BiquadChain's impl and the IR banks Conv1D and Conv1D_accel keep on
# the device, in the memory report.
PORT_ONLY = {"metadata.collectiveInventory", "metadata.matmulPrecision",
             "metadata.blockForm", "metadata.impl", "metadata.memory.irBank",
             "metadata.memory.irSpectra"}
JAX_ONLY = {"metadata.ici_model"}


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue().splitlines()


def _json(lines):
    start = next(i for i, ln in enumerate(lines) if ln in ("{", "["))
    close = "}" if lines[start] == "{" else "]"
    end = len(lines) - 1 - lines[::-1].index(close)
    rec = json.loads("\n".join(lines[start:end + 1]))
    return rec if isinstance(rec, list) else [rec]


def _paths(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "ici_model":
            out |= _paths(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def dp_cli():
    return _run(cli.main, DP_ARGV, device="cpu")


def test_cli_runs_every_sharded_name_on_4_ranks(dp_cli):
    rc, lines = dp_cli
    assert rc == 0, lines[-30:]
    assert lines[0] == "SPMD: 4 ranks over gloo, dataParallel 4"
    recs = _json(lines)
    assert [r["benchmark"] for r in recs] == SHARDED
    for r in recs:
        assert r["validation"]["status"] == "SUCCESS", r["benchmark"]
        assert "collectiveInventory" in r["metadata"], r["benchmark"]


def test_cli_json_keys_are_the_references(dp_cli):
    ours = _json(dp_cli[1])
    rc, jlines = _run(lambda a: jax_cli.main(a), DP_ARGV)
    assert rc == 0
    theirs = _json(jlines)
    assert [t["benchmark"] for t in theirs] == SHARDED
    for o, t in zip(ours, theirs):
        skip = PORT_ONLY | JAX_ONLY
        assert _paths(o) - skip == _paths(t) - skip, o["benchmark"]
        assert o["configuration"] == t["configuration"]
        assert o["validation"]["status"] == t["validation"]["status"]


def test_help_lists_the_flag_as_the_reference_does():
    _, ours = _run(cli.main, ["--help"])
    _, theirs = _run(lambda a: jax_cli.main(a), ["--help"])
    line = next(ln for ln in theirs if ln.lstrip().startswith(
        "--dataParallel"))
    assert line in ours
    assert "--dataParallel" not in cli.UNPORTED_FLAGS


def _jax_error(name, **kw):
    with pytest.raises(ValueError) as e:
        jax_create(name, JaxConfig(write_latencies=False, n_runs=1,
                                   warmup=0, **kw)).setup()
    return str(e.value)


@pytest.mark.parametrize("name", UNSHARDED)
def test_the_unsharded_names_refuse_with_the_jax_message(name):
    want = _jax_error(name, data_parallel=2)
    b = create_benchmark(name, BenchConfig(data_parallel=2), CPU)
    with pytest.raises(ValueError) as e:
        b.setup()
    assert str(e.value) == want


@pytest.mark.parametrize("name,kw", [
    ("gain", {"n_tracks": 9, "buffer_size": 64}),
    ("datacopy2080", {"transfer_mib": 1}),
])
def test_divisibility_errors_carry_the_jax_text(name, kw):
    want = _jax_error(name, data_parallel=8, **kw)
    assert "must be divisible by --dataParallel (8)" in want
    b = create_benchmark(name, BenchConfig(data_parallel=8, **kw), CPU)
    with pytest.raises(ValueError) as e:
        b.setup()
    assert str(e.value) == want


def test_runner_refuses_a_benchmark_that_declared_no_axis():
    class Opaque(Benchmark):
        name = "opaque"

        def setup(self):
            pass

    class JaxOpaque(JaxBenchmark):
        name = "opaque"

        def setup(self):
            pass

    with pytest.raises(ValueError) as want:
        jax_run(JaxOpaque(JaxConfig(data_parallel=8)),
                JaxConfig(data_parallel=8), verbose=False)
    cfg = BenchConfig(data_parallel=8)
    with pytest.raises(ValueError) as got:
        run_benchmark(Opaque(cfg, CPU), cfg, verbose=False)
    assert str(got.value) == str(want.value)


def test_more_ranks_than_devices_exit_1_naming_the_count():
    rc, lines = _run(cli.main, ["--benchmark", "gain", "--nTracks", "9",
                                "--dataParallel", "9"], device="cpu")
    assert rc == 1
    assert any("--dataParallel 9 needs 9 devices; 8 available" in ln
               for ln in lines), lines[-5:]
