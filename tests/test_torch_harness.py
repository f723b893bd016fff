"""The PyTorch port's harness (runner, saturated tier, base class, device
and build helpers, and its copies of the reference's config, statistics
and validation) on the CPU at toy size."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu import config as jax_config
from gpuaudiobench_tpu.harness import statistics as jax_statistics
from gpuaudiobench_tpu.harness import validation as jax_validation
from gpuaudiobench_tpu_torch import config as tconfig
from gpuaudiobench_tpu_torch import profile_block
from gpuaudiobench_tpu_torch.harness import statistics as tstatistics
from gpuaudiobench_tpu_torch.harness import streaming
from gpuaudiobench_tpu_torch.harness import validation as tvalidation
from gpuaudiobench_tpu_torch.harness.base import Benchmark, BenchmarkResult
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models.modal import ModalFilterBankBenchmark
from gpuaudiobench_tpu_torch.utils import build
from gpuaudiobench_tpu_torch.utils import device as dev

calculate_statistics = tstatistics.calculate_statistics
CPU = torch.device("cpu")


@pytest.fixture
def port_cfg(small_cfg):
    """The shared toy configuration as the port's own BenchConfig."""
    return tconfig.BenchConfig(**{
        f.name: getattr(small_cfg, f.name)
        for f in dataclasses.fields(tconfig.BenchConfig)})


@pytest.fixture
def modal(port_cfg):
    b = ModalFilterBankBenchmark(port_cfg, CPU)
    b.setup()
    return b


def test_config_fields_match_the_reference():
    """Every knob of the port's BenchConfig is the reference's, with its
    default."""
    ref = {f.name: f for f in dataclasses.fields(jax_config.BenchConfig)}
    ours = {f.name for f in dataclasses.fields(tconfig.BenchConfig)}
    for f in dataclasses.fields(tconfig.BenchConfig):
        assert f.name in ref, f.name
        assert f.default == ref[f.name].default, f.name
        assert f.type == ref[f.name].type, f.name
    # the RndMem, DWG and FDTD knobs
    assert {"rndmem_pool_mb", "rndmem_min_loop", "rndmem_max_loop",
            "dwg_min_length", "dwg_max_length", "fdtd_per_track_receivers",
            "fdtd_room", "sol_fma_k", "sol_fma_mib", "sol_stream_mib",
            "sol_vmem_mib", "sol_matmul_dim"} <= ours


@pytest.mark.parametrize("n", [0, 1, 2, 7, 21, 30])
def test_statistics_match_the_reference(rng, n):
    lat = (rng.random(n) * 3.0 + 0.1).tolist()
    ours = tstatistics.calculate_statistics(lat)
    ref = jax_statistics.calculate_statistics(lat)
    assert dataclasses.asdict(ours) == pytest.approx(
        dataclasses.asdict(ref), rel=1e-12, abs=0.0)


@pytest.mark.parametrize("mode,limit,floor,scale", [
    ("full", 1024, 0.0, 1.0),
    ("spot", 100, 0.0, 1.0),
    ("spot", 100, 2.0, 1.0 + 3e-5),
    ("full", 1024, 1.0, 1.01),
    ("none", 1024, 0.0, 1.01),
])
def test_compare_rel_matches_the_reference(rng, mode, limit, floor, scale):
    ref = (rng.random((8, 130)) * 2 - 1).astype(np.float32)
    ref[0, :3] = 0.0  # the absolute branch where ref == 0
    out = (ref * np.float32(scale)).astype(np.float32)
    out[0, 1] = 1e-6
    args = (out, ref, 1e-4)
    kw = dict(mode=mode, limit=limit, label="m", floor=floor)
    ours = tvalidation.compare_rel(*args, **kw)
    theirs = jax_validation.compare_rel(*args, **kw)
    assert ours.status.value == theirs.status.value
    assert ours.passed == theirs.passed
    for k in ("max_error", "mean_error", "error_count", "samples_checked",
              "messages"):
        assert getattr(ours, k) == getattr(theirs, k), k
    mismatch = tvalidation.compare_rel(out[:, :5], ref, 1e-4, mode=mode)
    assert mismatch.status.value == jax_validation.compare_rel(
        out[:, :5], ref, 1e-4, mode=mode).status.value


@pytest.mark.parametrize("total,limit", [(10, 20), (1000, 64), (1025, 1024)])
def test_spot_indices_match_the_reference(total, limit):
    assert np.array_equal(tvalidation.spot_indices(total, limit),
                          jax_validation.spot_indices(total, limit))


def _counting_step():
    calls = []

    def step(carry):
        calls.append(carry)
        return carry + 1, torch.tensor([float(carry)])

    return step, calls


def test_run_chained_carries_state_and_stacks_probes():
    step, calls = _counting_step()
    probes = streaming.run_chained(step, 10, 5)
    assert calls == [10, 11, 12, 13, 14]
    assert probes.device.type == "cpu"
    assert probes.tolist() == [10.0, 11.0, 12.0, 13.0, 14.0]


def test_measure_saturated_multi_warms_then_times_round_robin():
    step, calls = _counting_step()
    out = streaming.measure_saturated_multi(step, 0, [2, 3], reps=4)
    # one untimed warm pass per depth, then 4 reps of each depth
    assert len(calls) == (2 + 3) + 4 * (2 + 3)
    assert [len(x) for x in out] == [4, 4]
    assert all(v >= 0 for x in out for v in x)


def test_probe_is_mean_abs():
    y = torch.tensor([[1.0, -3.0], [2.0, -2.0]])
    p = streaming.probe(y)
    assert p.shape == (1,) and p.item() == 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_probe_equals_mean_abs(dtype):
    """One pass for a float output, abs then mean for an integer one:
    both give mean(|y|) in float32."""
    g = np.random.Generator(np.random.MT19937(3))
    y = torch.from_numpy((g.random((37, 129)) * 200 - 100).astype(np.float32))
    y = y.to(dtype)
    p = streaming.probe(y)
    want = torch.mean(torch.abs(y), dtype=torch.float32)
    assert p.shape == (1,) and p.dtype == torch.float32
    torch.testing.assert_close(p[0], want, rtol=1e-6, atol=0)


def test_saturated_marginal_statistics(modal):
    step, carry = modal.stream_body()
    reps, depth = 5, 8
    sat, marg, lo = streaming.measure_saturated_marginal(
        step, carry, depth, reps)
    assert lo == 2
    assert len(sat) == len(marg) == reps
    for lat in (sat, marg):
        st = calculate_statistics(lat)
        assert st.count == reps
        for v in (st.mean, st.median, st.p95, st.p99, st.min_val, st.max_val):
            assert math.isfinite(v)
    assert all(v > 0 for v in sat)


def test_saturated_marginal_rejects_lo_not_below_depth():
    step, _ = _counting_step()
    with pytest.raises(ValueError, match="lo_depth"):
        streaming.measure_saturated_marginal(step, 0, 4, 1, lo_depth=4)


def test_run_benchmark_end_to_end(modal, port_cfg):
    cfg = port_cfg.replace(pipeline_depth=8, saturated_reps=3)
    res = run_benchmark(modal, cfg, verbose=False)
    assert isinstance(res, BenchmarkResult)
    assert len(res.latencies) == cfg.n_runs
    assert res.statistics.count == cfg.n_runs
    assert res.pipeline_depth == 8 and res.saturated_lo_depth == 2
    assert len(res.saturated_latencies) == 3
    assert len(res.saturated_marginal_latencies) == 3
    assert res.validation.passed
    assert res.bytes_processed == modal.bytes_processed()
    assert res.throughput_gbps > 0 and res.samples_per_sec > 0
    assert res.metadata["impl"] == "torch-plain"
    mem = res.metadata["memory"]
    assert mem["totalBytes"] == mem["modeParams"] + mem["outputBuffer"]


def test_run_benchmark_single_depth_when_marginal_off(modal, port_cfg):
    cfg = port_cfg.replace(pipeline_depth=4, saturated_reps=2,
                            saturated_marginal=False)
    res = run_benchmark(modal, cfg, verbose=False)
    assert len(res.saturated_latencies) == 2
    assert res.saturated_marginal_statistics is None


@pytest.mark.parametrize("knob", [
    {"overlap_depth": 2},
    {"capture": True},
    {"dawsim": True},
    {"overlap_depth": 4},
    {"data_parallel": 2},
])
def test_runner_refuses_unported_tiers(modal, port_cfg, knob):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_benchmark(modal, port_cfg.replace(**knob), verbose=False)


def test_resolve_impl(port_cfg):
    """The hand kernel exactly on a CUDA device, the plain twin exactly
    on the CPU; impl xla on CUDA and devices without either raise."""
    cuda = torch.device("cuda:0")  # a descriptor: no GPU needed
    for impl in ("auto", "pallas", "xla"):
        cfg = port_cfg.replace(impl=impl)
        assert Benchmark(cfg, CPU).resolve_impl() == "torch-plain"
        if impl != "xla":
            assert Benchmark(cfg, cuda).resolve_impl() == "cuda-kernel"
    with pytest.raises(ValueError, match="xla"):
        Benchmark(port_cfg.replace(impl="xla"), cuda).resolve_impl()
    with pytest.raises(ValueError, match="no implementation"):
        Benchmark(port_cfg, torch.device("meta")).resolve_impl()
    with pytest.raises(ValueError, match="xla"):
        ModalFilterBankBenchmark(port_cfg.replace(impl="xla"), cuda)


def test_memory_report(port_cfg):
    b = Benchmark(port_cfg, CPU)
    assert b.memory_report() == {}
    b.track_alloc("a", 10)
    b.track_alloc("b", 5)
    assert b.memory_report() == {"a": 10, "b": 5, "totalBytes": 15}
    assert b.total_elements() == port_cfg.buffer_size * port_cfg.n_tracks
    assert b.transfer_model() == {"h2d_bytes": b.total_elements() * 4,
                                  "d2h_bytes": b.total_elements() * 4}


def test_device_helpers_on_cpu():
    assert dev.device("cpu") == CPU
    a = np.arange(6, dtype=np.float32)[::2]
    t = dev.to_device(a, CPU)
    assert t.device == CPU and np.array_equal(dev.from_device(t), a)
    dev.block(CPU)
    assert dev.gpu_identity(CPU) == {"device_name": "cpu", "power_limit": None}
    with pytest.raises(ValueError):
        dev.device("tpu")


def test_profile_summary_takes_the_union_of_device_intervals():
    events = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k1", 20.0, 30.0)]
    s = profile_block._summarize(events, blocks=2)
    assert s["kernel_us_per_block"] == {"k1": 10.0, "k2": 3.5}
    assert s["device_busy_us_per_block"] == 11.0  # (12 + 10) / 2
    assert s["window_us_per_block"] == 15.0
    assert s["device_idle_share"] == pytest.approx(8.0 / 30.0)
    assert "error" in profile_block._summarize([], blocks=2)


def test_profile_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        profile_block.main([])


@pytest.mark.parametrize("argv,name,knobs,depth", [
    ([], "ModalFilterBank", {"n_tracks": 1024}, profile_block.DEPTH),
    (["--benchmark", "FDTD3D", "--nTracks", "128", "--fdtdRoom", "30",
      "--depth", "64"], "FDTD3D", {"n_tracks": 128, "fdtd_room": 30}, 64),
    (["--benchmark", "DWG1DNaive", "--nTracks", "32768", "--depth", "256"],
     "DWG1DNaive", {"n_tracks": 32768}, 256),
    (["--benchmark", "RndMemRead", "--nTracks", "65536"], "RndMemRead",
     {"n_tracks": 65536}, profile_block.DEPTH),
])
def test_profile_parses_its_flags(argv, name, knobs, depth):
    got_name, cfg, got_depth = profile_block._parse(argv)
    assert (got_name, got_depth) == (name, depth)
    assert cfg.verification == "none" and not cfg.device_timing
    for k, v in knobs.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("argv", [["--depth", "8"], ["--fdtdRoom", "4"],
                                  ["--bogus", "1"], ["--depth"]])
def test_profile_rejects_bad_flags(argv):
    with pytest.raises((SystemExit, ValueError)):
        profile_block._parse(argv)


def test_library_path_is_keyed_on_sources_and_flags(monkeypatch):
    p = build.library_path("modal_bank")
    assert p.parent == build.BUILD_DIR
    assert p.name.startswith("modal_bank-") and p.suffix == ".so"
    assert build.library_path("modal_bank") == p
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("modal_bank") != p


def test_nvcc_path_search_order(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.nvcc_path() == str(fake)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    if build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc under /usr/local/cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


# -- the device tier (harness/device_timing.py) ---------------------------

class _StreamOnly(Benchmark):
    """A benchmark with a stream body and no device_iterate."""
    name = "StreamOnly"

    def stream_body(self):
        def step(carry):
            return carry, torch.ones(1)
        return step, 0


def test_device_tier_on_cpu_is_labelled_wall(modal, port_cfg):
    from gpuaudiobench_tpu_torch.harness import device_timing

    times, method = device_timing.measure_device_times(
        modal, port_cfg.replace(n_runs=3))
    assert method == "wall" and len(times) == 3
    assert all(t > 0 for t in times)


def test_device_tier_caps_the_runs(modal, port_cfg):
    from gpuaudiobench_tpu_torch.harness import device_timing

    times, _ = device_timing.measure_device_times(
        modal, port_cfg.replace(n_runs=50))
    assert len(times) == device_timing.MAX_RUNS == 20


def test_device_tier_falls_back_to_the_pipeline_slope(port_cfg):
    from gpuaudiobench_tpu_torch.harness import device_timing

    times, method = device_timing.measure_device_times(
        _StreamOnly(port_cfg, CPU), port_cfg.replace(saturated_reps=3))
    assert method == "pipeline-slope" and len(times) == 3
    assert all(t >= 0 for t in times)


def test_device_tier_without_a_body_is_unsupported(port_cfg):
    from gpuaudiobench_tpu_torch.harness import device_timing

    class Bare(Benchmark):
        name = "Bare"

    assert device_timing.measure_device_times(
        Bare(port_cfg, CPU), port_cfg) == (None, "unsupported")


def test_runner_fills_the_device_tier(modal, port_cfg):
    res = run_benchmark(modal, port_cfg.replace(device_timing=True),
                        verbose=False)
    assert res.device_timing_method == "wall"
    assert len(res.device_latencies) == port_cfg.n_runs
    assert res.device_statistics.count == port_cfg.n_runs
