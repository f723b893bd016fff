"""The port's streaming-state checkpoint (``harness/checkpoint.py``)
against the JAX package's, on the CPU at toy sizes.

Every ported benchmark's stream carry round-trips bit for bit against a
fresh template and the resumed stream continues as the uninterrupted one
does; the refusals carry the reference's messages (both packages read
the same file); a checkpoint the JAX package writes of ModalFilterBank's
carry (its Pallas form, in interpret mode) loads into the port's
template from the same seed with equal arrays; Python ints come back as
ints and bfloat16 leaves bit for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.harness import checkpoint as jck
from gpuaudiobench_tpu.models.modal import ModalFilterBankBenchmark as JaxModal
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import checkpoint as ck
from gpuaudiobench_tpu_torch.harness.graph import leaves
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
BASE = BenchConfig(n_tracks=8, buffer_size=64, n_runs=2, warmup=1,
                   device_timing=False, verification="none",
                   write_latencies=False)
# Every ported benchmark with a stream body, at toy widths (the knobs of
# tests/test_torch_guards.py's walk); the datacopy family has none.
STREAMS = [
    ("ModalFilterBank", {}), ("IIRFilter", {}),
    ("IIRFilter", {"iir_form": "blockstate"}), ("BiquadChain", {}),
    ("NoOp", {}), ("gain", {}), ("GainStats", {}), ("FFT1D", {}),
    ("Conv1D", {"ir_length": 40}), ("Conv1D_accel", {"ir_length": 40}),
    ("RndMemRead", {"rndmem_pool_mb": 1}),
    ("DWG1DNaive", {"dwg_min_length": 20, "dwg_max_length": 200}),
    ("DWG1DAccel", {"dwg_max_length": 300}),
    ("FDTD3D", {"fdtd_room": 8, "buffer_size": 16}),
    ("FDTD3D", {"fdtd_room": 8, "buffer_size": 16,
                "fdtd_per_track_receivers": True}),
    ("SOL_VPU", {"sol_fma_k": 8, "sol_fma_mib": 1}),
    ("SOL_VMEM", {"sol_fma_k": 8, "sol_vmem_mib": 1}),
    ("SOL_HBM", {"sol_stream_mib": 1}),
    ("SOL_MXU_bf16", {"sol_matmul_dim": 64}),
    ("SOL_MXU_f32", {"sol_matmul_dim": 64}),
    ("SOL_MXU_int8", {"sol_matmul_dim": 64}),
    ("PartConv", {"ir_length": 300}),
    ("PartConv", {"ir_length": 300, "partconv_form": "ring"}),
    ("PartConv", {"ir_length": 300, "partconv_form": "nupols",
                  "partconv_tail_chunk": 2}),
    ("DAWSessionMix", {"ir_length": 300}),
    ("NeuralAmp", {"neuralamp_channels": 16, "neuralamp_layers": 3}),
    ("NeuralAmp", {"neuralamp_channels": 16, "neuralamp_layers": 3,
                   "neuralamp_dtype": "bf16"}),
    ("NeuralAmp", {"neuralamp_channels": 16, "neuralamp_layers": 3,
                   "neuralamp_dtype": "int8"}),
    ("NeuralAmpLSTM", {"neuralamp_channels": 16}),
    ("NeuralAmpLSTM", {"neuralamp_channels": 16, "neuralamp_dtype": "bf16"}),
    ("MultiChipSuite", {}),
    ("ICIBandwidth", {"transfer_mib": 1}),
]


def _stream(name, cfg):
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    return b.stream_body()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b) -> bool:
    """The same leaf, bit for bit (a tensor's dtype, device and bytes; a
    Python value's type and value)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and a.shape == b.shape
                and torch.equal(_bytes(a), _bytes(b)))
    return type(a) is type(b) and a == b


def _label(p):
    name, knobs = p
    return name + "".join(f"-{v}" for v in knobs.values())


def test_every_ported_stream_is_covered():
    from gpuaudiobench_tpu_torch.harness.base import Benchmark
    from gpuaudiobench_tpu_torch.registry import ported_benchmarks

    streaming = {n for n in ported_benchmarks()
                 if type(create_benchmark(n, BASE, CPU)).stream_body
                 is not Benchmark.stream_body}
    assert streaming == {name for name, _ in STREAMS}


@pytest.mark.parametrize("case", STREAMS, ids=[_label(p) for p in STREAMS])
def test_stream_carry_roundtrips_and_resumes(tmp_path, case):
    name, knobs = case
    cfg = BASE.replace(**knobs)
    step, carry = _stream(name, cfg)
    for _ in range(2):  # a carry that has moved off its entry value
        carry, _ = step(carry)
    path = str(tmp_path / "state.npz")
    n = ck.save_stream_state(path, carry, benchmark=name,
                             extra={"soak_seconds": 2})
    assert n == len(leaves(carry))
    hdr = ck.read_header(path)
    assert hdr["benchmark"] == name and hdr["extra"]["soak_seconds"] == 2
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]

    step2, template = _stream(name, cfg)
    restored, _ = ck.load_stream_state(path, template, benchmark=name)
    assert all(_same(a, b) for a, b in zip(leaves(carry), leaves(restored)))
    assert type(restored) is type(template)

    _, p_direct = step(carry)
    _, p_resumed = step2(restored)
    assert torch.equal(p_direct, p_resumed)


def test_python_ints_come_back_as_ints(tmp_path):
    cfg = BASE.replace(ir_length=300, partconv_form="ring")
    step, carry = _stream("PartConv", cfg)
    carry, _ = step(carry)
    ints = [v for v in leaves(carry) if not isinstance(v, torch.Tensor)]
    assert ints and all(isinstance(v, int) for v in ints)
    path = str(tmp_path / "ring.npz")
    ck.save_stream_state(path, carry, benchmark="PartConv")
    assert "int64" in [leaf["dtype"] for leaf in ck.read_header(path)["leaves"]]
    _, template = _stream("PartConv", cfg)
    restored, _ = ck.load_stream_state(path, template)
    got = [v for v in leaves(restored) if not isinstance(v, torch.Tensor)]
    assert got == ints and all(type(v) is int for v in got)


def test_bfloat16_leaves_bit_for_bit(tmp_path, rng):
    bits = rng.integers(-2**15, 2**15, (5, 7), dtype=np.int64)
    bf = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    carry = (torch.ones(3), (bf, 4))
    path = str(tmp_path / "bf.npz")
    ck.save_stream_state(path, carry)
    assert ck.read_header(path)["leaves"][1]["dtype"] == "bfloat16"
    template = (torch.zeros(3), (torch.zeros((5, 7), dtype=torch.bfloat16), 0))
    (ones, (got, four)), _ = ck.load_stream_state(path, template)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), bf.view(torch.int16))
    assert four == 4 and type(four) is int


def test_jax_written_bfloat16_leaf_loads_bit_for_bit(tmp_path, rng):
    x = rng.standard_normal((4, 6)).astype(np.float32)
    path = str(tmp_path / "jbf.npz")
    jck.save_stream_state(path, (jnp.asarray(x, jnp.bfloat16),))
    (got,), _ = ck.load_stream_state(
        path, (torch.zeros((4, 6), dtype=torch.bfloat16),))
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    assert np.array_equal(got.view(torch.int16).numpy(), want)


def _port(cfg):
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


@pytest.fixture(scope="module")
def jax_modal_checkpoint(tmp_path_factory):
    """The JAX package's ModalFilterBank stream carry in its Pallas form
    (4 leaves, interpret mode), advanced 3 blocks, written by its own
    ``save_stream_state``; and its config."""
    cfg = JaxConfig(n_tracks=8, buffer_size=64, n_runs=1, warmup=1,
                    write_latencies=False, device_timing=False,
                    verification="none", impl="pallas")
    jb = JaxModal(cfg)
    with pltpu.force_tpu_interpret_mode():
        jb.setup()
        step, carry = jb.stream_body()
        entry = carry
        for _ in range(3):
            carry, _ = step(carry)
    path = str(tmp_path_factory.mktemp("jck") / "modal.npz")
    jck.save_stream_state(path, carry, benchmark="ModalFilterBank")
    return path, cfg, entry, carry


def test_jax_checkpoint_loads_into_the_port(jax_modal_checkpoint):
    path, cfg, entry, carry = jax_modal_checkpoint
    pb = create_benchmark("ModalFilterBank", _port(cfg).replace(impl="auto"),
                          CPU)
    pb.setup()
    _, template = pb.stream_body()
    # The same seed gives the port the JAX package's entry carry.
    for a, b in zip(leaves(template), entry):
        assert np.array_equal(a.numpy(), np.asarray(b))
    restored, hdr = ck.load_stream_state(path, template,
                                         benchmark="ModalFilterBank")
    assert hdr["format"] == jck.FORMAT == ck.FORMAT
    for a, b in zip(leaves(restored), carry):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_jax_carry_of_other_leaves_is_refused_by_count(tmp_path, small_cfg):
    # The JAX package's XLA form carries 5 leaves (amp too); the port's 4.
    jb = JaxModal(small_cfg.replace(impl="xla", verification="none"))
    jb.setup()
    _, jcarry = jb.stream_body()
    path = str(tmp_path / "xla.npz")
    jck.save_stream_state(path, jcarry, benchmark="ModalFilterBank")
    pb = create_benchmark("ModalFilterBank", BASE, CPU)
    pb.setup()
    _, template = pb.stream_body()
    with pytest.raises(ValueError) as ours:
        ck.load_stream_state(path, template, benchmark="ModalFilterBank")
    assert str(ours.value) == (f"{path}: checkpoint has 5 leaves, template "
                               "has 4")


def _messages(fn_port, fn_jax):
    with pytest.raises(ValueError) as ours:
        fn_port()
    with pytest.raises(ValueError) as theirs:
        fn_jax()
    return str(ours.value), str(theirs.value)


def test_refusals_carry_the_reference_messages(tmp_path,
                                               jax_modal_checkpoint):
    path, cfg, _, carry = jax_modal_checkpoint
    # A template of another shape: 16 tracks' modes.
    big_j = tuple(jnp.concatenate([a, a]) for a in carry)
    big_p = tuple(torch.zeros(2 * a.shape[0]) for a in carry)
    ours, theirs = _messages(
        lambda: ck.load_stream_state(path, big_p),
        lambda: jck.load_stream_state(path, big_j))
    assert ours == theirs and "leaf 0 is float32[8192]" in ours
    # Another dtype.
    ours, theirs = _messages(
        lambda: ck.load_stream_state(
            path, tuple(torch.zeros(a.shape[0], dtype=torch.float64)
                        for a in carry)),
        lambda: jck.load_stream_state(
            path, tuple(np.zeros(a.shape[0]) for a in carry)))
    assert ours == theirs and "template wants float64[8192]" in ours
    # Another benchmark.
    p_tmpl = tuple(torch.zeros(a.shape[0]) for a in carry)
    ours, theirs = _messages(
        lambda: ck.load_stream_state(path, p_tmpl, benchmark="DWG1DNaive"),
        lambda: jck.load_stream_state(path, carry, benchmark="DWG1DNaive"))
    assert ours == theirs and "not 'DWG1DNaive'" in ours
    # Another leaf count.
    ours, theirs = _messages(
        lambda: ck.load_stream_state(path, p_tmpl[:3]),
        lambda: jck.load_stream_state(path, carry[:3]))
    assert ours == theirs
    # Files that are no checkpoint.
    junk = str(tmp_path / "junk.npz")
    np.savez(junk, header=np.frombuffer(b'{"format": "x"}', np.uint8))
    nohdr = str(tmp_path / "nohdr.npz")
    np.savez(nohdr, leaf_0000=np.zeros(3))
    torn = str(tmp_path / "torn.npz")
    with open(torn, "wb") as f:
        f.write(b"PK\x03\x04 not a zip")
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, header=np.frombuffer(b"{not json", np.uint8))
    for p in (junk, nohdr, torn, bad, str(tmp_path / "missing.npz")):
        ours, theirs = _messages(lambda: ck.read_header(p),
                                 lambda: jck.read_header(p))
        assert ours == theirs


def test_a_refused_load_restores_nothing(tmp_path):
    path = str(tmp_path / "s.npz")
    ck.save_stream_state(path, (torch.ones(4), torch.ones(2)))
    template = (torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="leaf 1"):
        ck.load_stream_state(path, template)
    assert torch.equal(template[0], torch.zeros(4))


def test_a_leaf_of_no_stored_form_is_refused(tmp_path):
    with pytest.raises(TypeError, match="tensors and ints only"):
        ck.save_stream_state(str(tmp_path / "f.npz"), (torch.ones(2), 0.5))
    assert not os.listdir(tmp_path)
