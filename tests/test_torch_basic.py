"""The basic tier (NoOp, gain, GainStats) and FFT1D of the PyTorch port
against the JAX package, end to end on the CPU at toy size (8 tracks x
64 samples; FFT1D pads to 1024).

Both packages generate the same seeded input. Tolerances, absolute:
outputs and stats 1e-6 (the same float32 arithmetic; the mean is summed
in another order), spectra 1e-5 per component (two float32 FFTs of the
same frames; the benchmark's own bar is 1e-3 on |d_re| + |d_im|).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.ops import elementwise as jax_elementwise
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.ops import elementwise, fft
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
NAMES = ["NoOp", "gain", "GainStats", "FFT1D"]
ATOL = {"NoOp": 1e-6, "gain": 1e-6, "GainStats": 1e-6, "FFT1D": 1e-5}


def _port(cfg):
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _pair(cfg, name):
    jb = jax_create(name, cfg)
    jb.setup()
    pb = create_benchmark(name, _port(cfg), CPU)
    pb.setup()
    return jb, pb


def _outputs(b, name):
    if name == "FFT1D":
        return [np.asarray(b.host_re), np.asarray(b.host_im)]
    out = [np.asarray(b.host_output)]
    if name == "GainStats":
        out.append(np.asarray(b.host_stats))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_benchmark_matches_jax(small_cfg, name):
    jb, pb = _pair(small_cfg, name)
    assert np.array_equal(pb.host_input, jb.host_input)
    for ours, theirs in zip(_outputs(pb, name), _outputs(jb, name)):
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, atol=ATOL[name], rtol=0)
    v = pb.validate()
    assert v.passed, v.messages[:3]
    assert jb.validate().passed
    assert pb.transfer_model() == jb.transfer_model()
    assert pb.bytes_processed() == jb.bytes_processed()
    assert pb.metadata() == jb.metadata()


@pytest.mark.parametrize("name", NAMES)
def test_benchmark_runs_through_the_runner(small_cfg, name):
    cfg = _port(small_cfg).replace(n_runs=2, warmup=1, pipeline_depth=4,
                                   saturated_reps=2, device_timing=True)
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.validation.passed, res.validation.messages[:3]
    assert len(res.saturated_latencies) == 2
    assert res.device_timing_method == "wall"  # the CPU's label


@pytest.mark.parametrize("name", NAMES)
def test_corrupted_result_fails_validation(small_cfg, name):
    _, pb = _pair(small_cfg, name)
    attr = {"FFT1D": "host_re"}.get(name, "host_output")
    bad = getattr(pb, attr).copy()
    bad.ravel()[3] += 0.01
    setattr(pb, attr, bad)
    assert not pb.validate().passed


def test_gainstats_stats_corruption_fails_validation(small_cfg):
    _, pb = _pair(small_cfg, "GainStats")
    pb.host_stats = pb.host_stats.copy()
    pb.host_stats[2, 1] += 1e-3
    assert not pb.validate().passed


@pytest.mark.parametrize("buffer_size", [64, 1024, 2048])
def test_fft_pads_and_truncates_like_the_reference(small_cfg, buffer_size):
    jb, pb = _pair(small_cfg.replace(buffer_size=buffer_size), "FFT1D")
    assert pb.host_input.shape == (8, 1024)
    assert np.array_equal(pb.host_input, jb.host_input)
    assert pb.validate().passed


def test_rfft_interleaved_is_the_cufft_complex_layout(rng):
    x = torch.from_numpy(rng.standard_normal((3, 1024), dtype=np.float32))
    out = fft.rfft_interleaved(x)
    assert out.shape == (3, 513, 2) and out.dtype == torch.float32
    ref = np.fft.rfft(x.numpy().astype(np.float64), axis=-1)
    np.testing.assert_allclose(out[..., 0].numpy(), ref.real, atol=1e-4)
    np.testing.assert_allclose(out[..., 1].numpy(), ref.imag, atol=1e-4)


def test_elementwise_ops_match_the_reference(rng):
    x = rng.standard_normal((5, 64), dtype=np.float32)
    tx = torch.from_numpy(x)
    y = elementwise.copy_op(tx)
    assert torch.equal(y, tx) and y.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(elementwise.gain_op(tx, 2.0).numpy(),
                                  np.asarray(jax_elementwise.gain_op(x, 2.0)))
    out, stats = elementwise.gain_stats_op(tx, 0.5)
    jout, jstats = jax_elementwise.gain_stats_op(x, 0.5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert stats.shape == (5, 2)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), atol=1e-6)
