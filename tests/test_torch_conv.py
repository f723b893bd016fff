"""The convolution slice of the PyTorch port (Conv1D, Conv1D_accel, their
ops and host copies) against the JAX package, on the CPU at toy size.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas FIR kernel runs in interpret mode, as tests/test_pallas_ops.py
runs it. Tolerances, absolute unless stated:

* the FIR twin against the JAX ``conv1d_direct`` (XLA and Pallas) and
  against the float64 golden: 1e-5 (f32 sums in another order; the
  reference's own bar, tests/test_pallas_ops.py:258);
* the FFT convolution: 1e-5 (both are float32 FFTs of the same inputs);
* benchmark outputs, port vs JAX: 1e-5; goldens bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu import config as jax_config
from gpuaudiobench_tpu.harness import validation as jax_validation
from gpuaudiobench_tpu.models.conv1d import conv1d_reference as jax_reference
from gpuaudiobench_tpu.ops import conv as jax_conv
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu.utils import data as jax_data
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import validation as tvalidation
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models.conv1d import conv1d_reference
from gpuaudiobench_tpu_torch.ops import conv as cops
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.utils import data as tdata

CPU = torch.device("cpu")
ATOL = 1e-5
SHORT_IR = [(4, 32, 8), (130, 48, 16), (8, 64, 7)]  # L - 1 <= S
LONG_IR = [(4, 8, 20), (6, 16, 40)]  # L - 1 > S


def _inputs(rng, t, s, l):
    x = rng.standard_normal((t, s), dtype=np.float32)
    ir = (rng.standard_normal((t, l), dtype=np.float32) * 0.1).astype(np.float32)
    return x, ir


def _port(cfg):
    """The reference's config as the port's, knob for knob."""
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


@pytest.mark.parametrize("mode", ["clamp", "bleed"])
@pytest.mark.parametrize("t,s,l", SHORT_IR)
def test_fir_twin_matches_jax_xla_and_pallas(rng, t, s, l, mode):
    x, ir = _inputs(rng, t, s, l)
    got = cops.conv1d_direct_plain(torch.from_numpy(x), torch.from_numpy(ir),
                                   mode).numpy()
    ref = np.asarray(jax_conv.conv1d_direct(x, ir, mode, impl="xla"))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_conv.conv1d_direct(x, ir, mode,
                                                   impl="pallas"))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["clamp", "bleed"])
@pytest.mark.parametrize("t,s,l", SHORT_IR + LONG_IR)
def test_fir_twin_meets_the_golden(rng, t, s, l, mode):
    x, ir = _inputs(rng, t, s, l)
    got = cops.conv1d_direct_plain(torch.from_numpy(x), torch.from_numpy(ir),
                                   mode).numpy()
    np.testing.assert_allclose(got, conv1d_reference(x, ir, mode),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,s,l", LONG_IR)
def test_reference_bleed_fault_is_not_copied(t, s, l):
    """With L - 1 > S the JAX package's bleed pads each track with the
    previous track only and misses its own golden, which reaches back
    L - 1 samples across as many tracks as that takes; the port meets the
    golden. Seed 7, x ~ N(0, 1), IRs ~ N(0, 0.1^2) (ROADMAP.md §3)."""
    x, ir = _inputs(np.random.Generator(np.random.MT19937(7)), t, s, l)
    golden = jax_reference(x, ir, "bleed")
    jax_err = np.abs(np.asarray(jax_conv.conv1d_direct(x, ir, "bleed"))
                     - golden).max()
    port = cops.conv1d_direct(torch.from_numpy(x), torch.from_numpy(ir),
                              "bleed").numpy()
    assert jax_err > 1e-3  # the golden's tolerance: the JAX function fails
    np.testing.assert_allclose(port, golden, atol=ATOL, rtol=0)


def test_reference_bleed_fault_size_at_the_recorded_config():
    """The config ROADMAP.md §3 records: T=6, S=16, L=40, seed 7."""
    x, ir = _inputs(np.random.Generator(np.random.MT19937(7)), 6, 16, 40)
    golden = jax_reference(x, ir, "bleed")
    jax_err = np.abs(np.asarray(jax_conv.conv1d_direct(x, ir, "bleed"))
                     - golden).max()
    assert jax_err > 0.4


@pytest.mark.parametrize("mode", ["clamp", "bleed"])
@pytest.mark.parametrize("t,s,l", SHORT_IR + LONG_IR)
def test_conv1d_reference_is_the_reference_golden(rng, t, s, l, mode):
    x, ir = _inputs(rng, t, s, l)
    full = conv1d_reference(x, ir, mode)
    assert np.array_equal(full, jax_reference(x, ir, mode))
    rows = np.array([0, t - 1])
    assert np.array_equal(conv1d_reference(x, ir, mode, rows), full[rows])


def test_fir_wrapper_on_cpu_is_the_twin(rng):
    x, ir = (torch.from_numpy(a) for a in _inputs(rng, 8, 64, 7))
    launches = dict(cops.KERNEL_LAUNCHES)
    for mode in ("clamp", "bleed"):
        assert torch.equal(cops.conv1d_direct(x, ir, mode),
                           cops.conv1d_direct_plain(x, ir, mode))
    assert cops.KERNEL_LAUNCHES == launches  # no kernel ran on the CPU


def test_fir_wrapper_rejects_bad_input(rng):
    x, ir = (torch.from_numpy(a) for a in _inputs(rng, 8, 64, 7))
    with pytest.raises(TypeError, match="float32"):
        cops.conv1d_direct(x.double(), ir)
    with pytest.raises(ValueError, match="contiguous"):
        cops.conv1d_direct(x.t().contiguous().t(), ir)
    with pytest.raises(ValueError, match="IRs for"):
        cops.conv1d_direct(x, ir[:4].contiguous())
    with pytest.raises(ValueError, match="edge mode"):
        cops.conv1d_direct(x, ir, "wrap")
    meta = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cops.conv1d_direct(meta, torch.empty((8, 7), device="meta"))


@pytest.mark.parametrize("t,s,l", [(4, 32, 8), (8, 64, 100)])
def test_fft_convolution_matches_jax(rng, t, s, l):
    x, ir = _inputs(rng, t, s, l)
    n = 1
    while n < s + l - 1:
        n <<= 1
    spec = cops.precompute_ir_spectra(torch.from_numpy(ir), n)
    assert spec.dtype == torch.complex64 and spec.shape == (t, n // 2 + 1)
    got = cops.conv1d_fft(torch.from_numpy(x), spec, n, s).numpy()
    ref = np.asarray(jax_conv.conv1d_fft(
        x, jax_conv.precompute_ir_spectra(ir, n), n, s))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, conv1d_reference(x, ir, "clamp"),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,l", [(8, 1024), (128, 512), (3, 7), (1, 2)])
def test_impulse_responses_are_the_reference_bank(t, l):
    assert np.array_equal(tdata.conv1d_impulse_responses(t, l),
                          jax_data.conv1d_impulse_responses(t, l))


@pytest.mark.parametrize("mode,limit", [("full", 1024), ("spot", 16),
                                        ("none", 1024)])
def test_compare_complex_matches_the_reference(rng, mode, limit):
    ref_re, ref_im = rng.standard_normal((2, 8, 513))
    out_re = ref_re + rng.standard_normal((8, 513)) * 1e-3
    out_im = ref_im + rng.standard_normal((8, 513)) * 1e-3
    ours = tvalidation.compare_complex(out_re, out_im, ref_re, ref_im, 2e-3,
                                       mode=mode, limit=limit, label="x")
    theirs = jax_validation.compare_complex(out_re, out_im, ref_re, ref_im,
                                            2e-3, mode=mode, limit=limit,
                                            label="x")
    assert ours.status.value == theirs.status.value
    assert ours.max_error == theirs.max_error
    assert ours.mean_error == theirs.mean_error
    assert ours.error_count == theirs.error_count
    assert ours.samples_checked == theirs.samples_checked
    assert ours.messages == theirs.messages


@pytest.mark.parametrize("knobs", [{}, {"ir_length": 512},
                                   {"conv_edge_mode": "bleed"}])
def test_conv_config_fields_match_the_reference(knobs):
    ours = BenchConfig(**knobs)
    theirs = jax_config.BenchConfig(**knobs)
    assert ours.ir_length == theirs.ir_length
    assert ours.conv_edge_mode == theirs.conv_edge_mode
    ours.validate()
    theirs.validate()


def test_conv_config_rejects_an_edge_mode_like_the_reference():
    with pytest.raises(ValueError) as ours:
        BenchConfig(conv_edge_mode="wrap").validate()
    with pytest.raises(ValueError) as theirs:
        jax_config.BenchConfig(conv_edge_mode="wrap").validate()
    assert str(ours.value) == str(theirs.value)


# -- the benchmarks, end to end against the JAX package ------------------

BENCH_CASES = {
    "clamp": ("Conv1D", {"ir_length": 16}),
    "bleed": ("Conv1D", {"ir_length": 16, "conv_edge_mode": "bleed"}),
    "accel": ("Conv1D_accel", {"ir_length": 16}),
    "accel_long": ("Conv1D_accel", {"ir_length": 100}),
}


@pytest.fixture
def jax_cfg(small_cfg):
    return small_cfg.replace(impl="xla")  # 8 tracks x 64 samples


def _pair(jax_cfg, case):
    name, knobs = BENCH_CASES[case]
    cfg = jax_cfg.replace(**knobs)
    jb = jax_create(name, cfg)
    jb.setup()
    pb = create_benchmark(name, _port(cfg), CPU)
    pb.load_data(jb.host_input, jb.ir)
    return jb, pb


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_benchmark_matches_jax(jax_cfg, case):
    jb, pb = _pair(jax_cfg, case)
    np.testing.assert_allclose(pb.host_output, np.asarray(jb.host_output),
                               atol=ATOL, rtol=0)
    v = pb.validate()
    assert v.passed, v.messages[:3]
    assert jb.validate().passed
    assert np.array_equal(pb.golden, jb.golden)
    assert pb.ir_length == jb.ir_length


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_setup_generates_the_reference_data(jax_cfg, case):
    name, knobs = BENCH_CASES[case]
    cfg = jax_cfg.replace(**knobs)
    jb = jax_create(name, cfg)
    jb.setup()
    pb = create_benchmark(name, _port(cfg), CPU)
    pb.setup()
    assert np.array_equal(pb.host_input, jb.host_input)
    assert np.array_equal(pb.ir, jb.ir)
    assert pb.metadata() == {**jb.metadata(), **(
        {"impl": "torch-plain"} if name == "Conv1D" else {})}


@pytest.mark.parametrize("name,default", [("Conv1D", 1024),
                                          ("Conv1D_accel", 512)])
def test_ir_length_defaults_per_benchmark(name, default):
    b = create_benchmark(name, BenchConfig(n_tracks=2, buffer_size=16), CPU)
    assert b.ir_length == default


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_spot_golden_is_the_full_golden_where_read(jax_cfg, case):
    _, full = _pair(jax_cfg, case)
    _, spot = _pair(jax_cfg.replace(verification="spot",
                                    spot_sample_limit=3), case)
    assert full.validate().passed and spot.validate().passed
    idx = tvalidation.spot_indices(full.golden.size, 3)
    assert np.array_equal(spot.golden.ravel()[idx], full.golden.ravel()[idx])
    if case in ("clamp", "bleed"):  # the rows a spot check skips are NaN
        assert np.isnan(spot.golden).any()


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_corrupted_output_fails_validation(jax_cfg, case):
    _, pb = _pair(jax_cfg, case)
    pb.host_output = pb.host_output.copy()
    pb.host_output.ravel()[5] += 0.5
    assert not pb.validate().passed


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_benchmark_runs_through_the_runner(jax_cfg, case):
    name, knobs = BENCH_CASES[case]
    cfg = _port(jax_cfg.replace(**knobs)).replace(
        n_runs=2, warmup=1, pipeline_depth=4, saturated_reps=2,
        device_timing=True)
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.validation.passed, res.validation.messages[:3]
    assert len(res.saturated_latencies) == 2
    assert res.device_timing_method == "wall"  # the CPU's label


def test_load_data_rejects_a_wrong_ir_bank(jax_cfg):
    pb = create_benchmark("Conv1D", _port(jax_cfg), CPU)
    with pytest.raises(ValueError, match="IR bank"):
        pb.load_data(np.zeros((8, 64), np.float32),
                     np.zeros((4, 16), np.float32))


def test_conv1d_refuses_impl_xla_on_cuda(jax_cfg):
    """On a CUDA device Conv1D runs only the kernel. A device descriptor
    needs no GPU."""
    with pytest.raises(ValueError, match="xla"):
        create_benchmark("Conv1D", _port(jax_cfg), torch.device("cuda:0"))
