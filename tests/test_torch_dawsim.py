"""The PyTorch port's DAW-sim pacing against the JAX package, on the CPU:
the Python pacer on a fake clock, the deadline miss rate, the native
pacer built with g++ from ``native/gpuab_native.cc``, and the runner's
and JSON's DAW-sim fields."""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.harness import dawsim as jax_dawsim
from gpuaudiobench_tpu.harness.output import (
    generate_json_results as jax_json,
)
from gpuaudiobench_tpu.harness.runner import run_benchmark as jax_run
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import dawsim
from gpuaudiobench_tpu_torch.harness.output import generate_json_results
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.harness.statistics import calculate_statistics
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.utils import native

CPU = torch.device("cpu")


class FakeClock:
    """perf_counter advances by ``tick`` a read (so a spin ends) and
    sleep by its argument; every sleep and every wait's end is logged."""

    def __init__(self, tick=1e-6):
        self.now = 100.0
        self.tick = tick
        self.sleeps = []

    def perf_counter(self):
        self.now += self.tick
        return self.now

    def sleep(self, d):
        self.sleeps.append(d)
        self.now += d


def _trace(module, monkeypatch, mode, jitter, seed, work):
    clock = FakeClock()
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(module.time, "sleep", clock.sleep)
    sim = module.DAWSimulator(256, 48000, mode, jitter, seed)
    ends = []
    for w in work:
        sim.wait()
        ends.append(clock.now)
        clock.now += w  # the iteration's own time
    monkeypatch.undo()
    return ends, clock.sleeps


@pytest.mark.parametrize("mode", ["sleep", "spin"])
@pytest.mark.parametrize("jitter,seed", [(0.0, 42), (300.0, 42),
                                         (2000.0, 7)])
def test_pacer_matches_the_jax_pacer_on_a_fake_clock(monkeypatch, mode,
                                                    jitter, seed):
    """The same waits from the same seed: jitter draws, overrun resync
    and the sleep durations."""
    work = [0.001, 0.004, 0.02, 0.0, 0.003, 0.009, 0.001, 0.012]
    ours = _trace(dawsim, monkeypatch, mode, jitter, seed, work)
    theirs = _trace(jax_dawsim, monkeypatch, mode, jitter, seed, work)
    assert ours == theirs
    ends, sleeps = ours
    assert (len(sleeps) > 0) == (mode == "sleep")


def test_pacer_rejects_a_bad_mode():
    with pytest.raises(ValueError, match="invalid dawsim mode"):
        dawsim.DAWSimulator(512, 48000, "doze")
    assert dawsim.DAWSimulator(512, 48000).pacer == "python"


@pytest.mark.parametrize("n", [0, 1, 10, 101])
def test_deadline_miss_rate_matches_the_jax_function(n):
    g = np.random.Generator(np.random.MT19937(n))
    lat = (g.random(n) * 20.0).tolist()
    for buf, fs in ((512, 48000), (128, 44100), (4096, 48000)):
        assert dawsim.deadline_miss_rate(lat, buf, fs) == \
            jax_dawsim.deadline_miss_rate(lat, buf, fs)


@pytest.mark.parametrize("n", [1, 2, 5, 100, 101])
def test_native_statistics_equal_the_port(n):
    g = np.random.Generator(np.random.MT19937(7 + n))
    vals = g.random(n).tolist()
    nat = native.calculate_statistics_native(vals)
    py = calculate_statistics(vals)
    assert nat.count == py.count == n
    for field in ("mean", "median", "std_dev", "min_val", "max_val", "p95",
                  "p99"):
        assert getattr(nat, field) == pytest.approx(getattr(py, field),
                                                    abs=1e-12), field


def test_native_library_is_keyed_on_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("gpuab_native-")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


def test_native_pacer_sleeps_to_the_buffer():
    sim = native.NativeDAWSimulator(480, 48000, "sleep")  # 10 ms buffers
    sim.wait()  # arms the schedule
    t0 = time.perf_counter()
    for _ in range(3):
        sim.wait()
    assert time.perf_counter() - t0 >= 0.025  # ~30 ms, scheduler slack
    sim.close()


def test_native_pacer_spins_to_the_buffer():
    sim = native.NativeDAWSimulator(48, 48000, "spin")  # 1 ms buffers
    # A preempted process can land past a boundary, where wait() rightly
    # returns at once: judge the median over a reset schedule, 3 tries.
    for _ in range(3):
        sim.reset()
        sim.wait()
        ts = []
        for _ in range(9):
            t0 = time.perf_counter()
            sim.wait()
            ts.append(time.perf_counter() - t0)
        med = sorted(ts)[len(ts) // 2]
        if 0.0005 < med < 0.005:
            break
    else:
        raise AssertionError(f"pacer median off after 3 attempts: {ts}")


def test_make_dawsim_prefers_native_and_falls_back(monkeypatch):
    sim = native.make_dawsim(512, 48000, "spin", 0.0, 42)
    assert sim.pacer == "native"

    def broken():
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(native, "load", broken)
    sim = native.make_dawsim(512, 48000, "sleep", 10.0, 42)
    assert isinstance(sim, dawsim.DAWSimulator) and sim.pacer == "python"
    assert sim.mode == "sleep" and sim.jitter_us == 10.0


@pytest.fixture
def port_cfg(small_cfg):
    return BenchConfig(**{f.name: getattr(small_cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


@pytest.mark.parametrize("mode", ["spin", "sleep"])
def test_runner_paces_and_reports_the_miss_rate(small_cfg, port_cfg, mode):
    """64-sample buffers at 48 kHz: 1.333 ms a buffer, 3 runs."""
    cfg = port_cfg.replace(dawsim=True, dawsim_mode=mode, n_runs=3)
    b = create_benchmark("gain", cfg, CPU)
    b.setup()
    t0 = time.perf_counter()
    r = run_benchmark(b, cfg, verbose=False)
    assert time.perf_counter() - t0 >= 2 * 64 / 48000  # two paced waits
    assert r.dawsim_pacer == "native"
    assert r.deadline_miss_rate == dawsim.deadline_miss_rate(
        r.latencies, 64, 48000)
    ours = generate_json_results(r, cfg, CPU)["deadline"]
    jcfg = small_cfg.replace(dawsim=True, dawsim_mode=mode, n_runs=3)
    ref = jax_create("gain", jcfg)
    ref.setup()
    theirs = jax_json(jax_run(ref, jcfg, verbose=False), jcfg)["deadline"]
    assert set(ours) == set(theirs) | {"pacer"}
    assert ours["pacer"] == "native"
    assert math.isclose(ours["threshold_ms"], theirs["threshold_ms"])


def test_no_deadline_fields_without_dawsim(port_cfg):
    b = create_benchmark("gain", port_cfg, CPU)
    b.setup()
    r = run_benchmark(b, port_cfg, verbose=False)
    assert r.deadline_miss_rate is None and r.dawsim_pacer is None
    dl = generate_json_results(r, port_cfg, CPU)["deadline"]
    assert "miss_rate_percent" not in dl and "pacer" not in dl
