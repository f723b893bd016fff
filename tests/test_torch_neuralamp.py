"""The PyTorch port's NeuralAmp and NeuralAmpLSTM (``models/neuralamp.py``)
against the JAX package's, on the CPU at toy size (T = 4, B = 64, C = 16,
L = 4, H = 16), from seeded NumPy inputs.

Tolerances: a block's output within 1e-5 of the JAX benchmark's peak in
f32 (full FP32 against ``Precision.HIGH``, sums in another order) and
within the benchmark's own tolerance in bf16 and int8; the benchmark's
validation against the f64 goldens at the JAX package's TOLERANCE
table; the stream, the overlapped pass and the device tier against the
port's own iterate, bit for bit (the same ops in the same order); the
cost model, the metadata and the memory report equal to the JAX
package's (the port adds ``matmulPrecision`` and the LSTM's
``blockForm``).
"""

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.models import neuralamp as jmodel
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import overlap
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models import neuralamp as tmodel
from gpuaudiobench_tpu_torch.ops import neuralamp as na

CPU = torch.device("cpu")
PATHS = [("tcn", "f32"), ("tcn", "bf16"), ("tcn", "int8"), ("lstm", "f32"),
         ("lstm", "bf16")]


def _cfgs(dtype="f32", **over):
    base = dict(n_tracks=4, buffer_size=64, neuralamp_channels=16,
                neuralamp_layers=4, neuralamp_dtype=dtype, n_runs=2,
                warmup=1, device_timing=False)
    base.update(over)
    return (BenchConfig(**base),
            JaxConfig(write_latencies=False, quiet=True, **base))


def _port(arch="tcn", dtype="f32", **over):
    cfg, _ = _cfgs(dtype, **over)
    b = tmodel.NeuralAmpBenchmark(cfg, CPU, arch)
    b.setup()
    return b


def _ref(arch="tcn", dtype="f32", **over):
    _, jcfg = _cfgs(dtype, **over)
    b = jmodel.NeuralAmpBenchmark(jcfg, arch)
    b.setup()
    return b


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def test_tolerances_are_the_references():
    assert tmodel.TOLERANCE == jmodel.TOLERANCE


@pytest.mark.parametrize("arch,dtype", PATHS)
def test_validate_passes_after_iterates(arch, dtype):
    b = _port(arch, dtype)
    for _ in range(5):  # setup ran one; past the TCN's steady state
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages[:3]
    assert v.max_error <= (1e-5 if dtype == "f32" else b.tolerance)
    assert b.host_output.shape == (4, 64)


@pytest.mark.parametrize("arch,dtype", PATHS)
def test_iterate_matches_the_reference_benchmark(arch, dtype):
    ours, ref = _port(arch, dtype), _ref(arch, dtype)
    for i in range(3):
        if i:
            ours.iterate()
            ref.iterate()
        rel = 1e-5 if dtype == "f32" else ours.tolerance
        assert _rel(ours.host_output, ref.host_output) <= rel, i


@pytest.mark.parametrize("arch,dtype", PATHS)
def test_streaming_matches_iterate(arch, dtype):
    """stream_body's step from the entry state, n times, is the block
    iterate runs n times (set-up's and n - 1 more), bit for bit, and
    block 4 of the stream meets the golden (the counterpart of
    tests/test_neuralamp.py:157)."""
    a, b = _port(arch, dtype), _port(arch, dtype)
    step, carry = a.stream_body()
    assert carry[0] is a._resident_input
    for _ in range(4):
        carry, p = step(carry)
        assert p.shape == (1,)
    for _ in range(3):
        b.iterate()
    for o, r in zip(carry[1], b._state):
        assert torch.equal(o, r)
    y, _ = a._block_fn(carry[1])(a._resident_input, carry[1])
    golden = (na.tcn_reference(a.host_input, 5, a.params_np, a.layers)
              if arch == "tcn"
              else na.lstm_reference(a.host_input, 5, a.params_np))
    assert _rel(y.numpy(), golden) <= a.tolerance


@pytest.mark.parametrize("arch", ["tcn", "lstm"])
def test_overlapped_pass_equals_the_serial_one(arch):
    b = _port(arch)
    step, blocks, carry = b.overlap_body()
    infeed = overlap.Infeed(blocks, CPU)
    got = {}
    for kind, loop in (("serial", overlap.run_serial),
                       ("overlapped", overlap.run_overlapped)):
        y, c = loop(infeed, step, tuple(t.clone() for t in carry), 6)
        got[kind] = [y.clone()] + [t.clone() for t in c]
    for s, o in zip(got["serial"], got["overlapped"]):
        assert torch.equal(s, o)


@pytest.mark.parametrize("arch", ["tcn", "lstm"])
def test_device_tier_leaves_the_state_alone(arch):
    b = _port(arch)
    b.iterate()
    entry = [t.clone() for t in b._timing_state]
    state = [t.clone() for t in b._state]
    for _ in range(3):
        b.device_iterate()
    for now, then in zip(b._timing_state, entry):
        assert torch.equal(now, then)
    for now, then in zip(b._state, state):
        assert torch.equal(now, then)
    assert not any(t.any() for t in b._timing_state)  # zeros: never written


@pytest.mark.parametrize("arch,dtype", PATHS)
def test_load_state_continues_a_reference_stream(arch, dtype):
    """The JAX benchmark runs 4 blocks; the port takes its state and block
    count, and both run 2 more: the outputs agree and the port
    validates."""
    ref, ours = _ref(arch, dtype), _port(arch, dtype)
    for _ in range(3):
        ref.iterate()
    ours.load_state([np.asarray(s) for s in ref._state], ref._invocations)
    for _ in range(2):
        ref.iterate()
        ours.iterate()
        rel = 1e-5 if dtype == "f32" else ours.tolerance
        assert _rel(ours.host_output, ref.host_output) <= rel
    v = ours.validate()
    assert v.passed, v.messages[:3]


def test_load_state_rejects_wrong_shapes():
    b = _port("lstm")
    with pytest.raises(ValueError, match="state shapes"):
        b.load_state([np.zeros((4, 8), np.float32)] * 2, 1)


@pytest.mark.parametrize("arch,dtype", PATHS)
def test_cost_model_and_metadata_match_the_reference(arch, dtype):
    ours, ref = _port(arch, dtype), _ref(arch, dtype)
    md, ref_md = ours.metadata(), ref.metadata()
    assert md.pop("matmulPrecision") == "highest"
    if arch == "lstm":
        assert md.pop("blockForm") == "eager"  # the CPU; "cuda-graph" on CUDA
    assert md == ref_md
    assert ours.cost_model() == ref.cost_model()
    assert ours.transfer_model() == ref.transfer_model()
    assert ours.bytes_processed() == ref.bytes_processed()
    assert ours.memory_report() == ref.memory_report()


def test_int8_refused_for_the_lstm_with_the_references_reason():
    cfg, jcfg = _cfgs("int8")
    with pytest.raises(ValueError, match="int8 is TCN-only") as ours:
        tmodel.NeuralAmpBenchmark(cfg, CPU, "lstm").setup()
    with pytest.raises(ValueError, match="int8 is TCN-only") as ref:
        jmodel.NeuralAmpBenchmark(jcfg, "lstm").setup()
    assert str(ours.value) == str(ref.value)


def test_int8_needs_channels_a_multiple_of_8():
    with pytest.raises(ValueError, match="multiple of 8"):
        _port("tcn", "int8", neuralamp_channels=12)


def test_setup_refuses_tf32_matmuls():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="NeuralAmp: .*TF32"):
            _port()
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("knob,value,match", [
    ("neuralamp_dtype", "f16", "NeuralAmp dtype"),
    ("neuralamp_layers", 13, "neuralamp_layers"),
    ("neuralamp_layers", 0, "neuralamp_layers"),
    ("neuralamp_channels", 513, "neuralamp_channels"),
])
def test_config_bounds_like_the_reference(knob, value, match):
    with pytest.raises(ValueError, match=match):
        BenchConfig(**{knob: value}).validate()
    with pytest.raises(ValueError, match=match):
        JaxConfig(**{knob: value}).validate()


@pytest.mark.parametrize("arch", ["tcn", "lstm"])
def test_every_tier_runs_through_the_runner(arch):
    cfg, _ = _cfgs(n_runs=3, pipeline_depth=8, saturated_reps=2,
                   overlap_depth=4, overlap_reps=1, device_timing=True,
                   verification="spot")
    b = tmodel.NeuralAmpBenchmark(cfg, CPU, arch)
    b.setup()
    r = run_benchmark(b, cfg, verbose=False)
    assert r.validation.passed, r.validation.messages[:3]
    assert r.device_timing_method == "wall"
    assert r.saturated_statistics is not None
    assert r.overlap_statistics is not None
    assert b._invocations == 1 + 1 + 3  # set-up, warmup, timed


@pytest.mark.parametrize("argv", [
    ["--benchmark", "NeuralAmp", "--neuralampDtype", "int8"],
    ["--benchmark", "NeuralAmpLSTM", "--neuralampDtype", "bf16"],
])
def test_cli_runs_and_validates(argv):
    rc = cli.main(argv + ["--nTracks", "4", "--bufferSize", "64",
                          "--neuralampChannels", "16", "--neuralampLayers",
                          "4", "--nRuns", "2", "--quiet", "--json"],
                  device="cpu")
    assert rc == 0


def test_cli_refuses_int8_for_the_lstm():
    assert cli.main(["--benchmark", "NeuralAmpLSTM", "--neuralampDtype",
                     "int8", "--nTracks", "4", "--neuralampChannels", "16",
                     "--quiet"], device="cpu") == 1
