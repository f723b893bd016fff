"""RndMemRead in the PyTorch port (the gather's plain twin, the benchmark,
its CLI path and the copied pool generator) against the JAX package, on
the CPU at toy size.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas gather runs in interpret mode, as tests/test_pallas_ops.py runs it,
on a pool that carries its ``POOL_PAD`` tail (the port's pool has none).
A gather copies samples, so agreement is bit for bit everywhere.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.ops.rndmem import rndmem_gather as jax_gather
from gpuaudiobench_tpu.ops.rndmem_pallas import POOL_PAD, rndmem_gather_pallas
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu.utils import data as jax_data
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.ops import rndmem as rops
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.utils import data as tdata

CPU = torch.device("cpu")
POOL = 64 * 1024
# The edge playheads of tests/test_pallas_ops.py: block-aligned, end of
# pool, row-aligned and mid-row offsets.
EDGE = [0, 1024, 513, 1000, POOL - 512, 2047, 12345, 777, 128, 127, 129,
        POOL - 513, POOL - 640, 255, POOL - 768, 511]


def _port(cfg):
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _gather(pool, ph, s):
    return rops.rndmem_gather_plain(torch.from_numpy(pool),
                                    torch.from_numpy(ph), s).numpy()


@pytest.mark.parametrize("s", [512, 128, 32])
def test_twin_matches_jax_gather_and_pallas(rng, s):
    pool = rng.random(POOL, dtype=np.float32)
    ph = np.concatenate([np.array(EDGE, np.int32),
                         rng.integers(0, POOL - 512, 16).astype(np.int32)])
    ph = np.minimum(ph, POOL - s).astype(np.int32)
    tmpl = np.zeros((len(ph), s), np.float32)
    padded = np.concatenate([pool, np.zeros(POOL_PAD, np.float32)])
    got = _gather(pool, ph, s)
    assert got.shape == (s, len(ph))
    np.testing.assert_array_equal(got, np.asarray(jax_gather(pool, ph, tmpl)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(rndmem_gather_pallas(padded, ph, tmpl))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("ph", [
    [POOL - 1, POOL - 511, POOL + 7, 2 ** 31 - 1],
    [-1, -512, -(2 ** 31), 0],
])
def test_twin_clamps_like_xla_dynamic_slice(rng, ph):
    """Playheads past P - S clamp to it, and negative ones count from the
    end first, as the JAX gather's dynamic_slice does (the Pallas kernel
    relies on POOL_PAD and does not clamp, so it is not compared here)."""
    pool = rng.random(POOL, dtype=np.float32)
    ph = np.array(ph, np.int32)
    tmpl = np.zeros((len(ph), 512), np.float32)
    got = _gather(pool, ph, 512)
    np.testing.assert_array_equal(got, np.asarray(jax_gather(pool, ph, tmpl)))
    starts = rops.clamped_starts(torch.from_numpy(ph), POOL, 512).numpy()
    assert starts.min() >= 0 and starts.max() == POOL - 512


def test_wrapper_on_cpu_is_the_twin(rng):
    pool = torch.from_numpy(rng.random(4096, dtype=np.float32))
    ph = torch.from_numpy(rng.integers(0, 4000, 40).astype(np.int32))
    launches = dict(rops.KERNEL_LAUNCHES)
    assert torch.equal(rops.rndmem_gather(pool, ph, 64),
                       rops.rndmem_gather_plain(pool, ph, 64))
    assert rops.KERNEL_LAUNCHES == launches


def test_wrapper_rejects_bad_input():
    pool, ph = torch.zeros(1024), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        rops.rndmem_gather(pool.double(), ph, 64)
    with pytest.raises(TypeError, match="int32"):
        rops.rndmem_gather(pool, ph.long(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        rops.rndmem_gather(torch.zeros(2048)[::2], ph, 64)
    with pytest.raises(ValueError, match="samples from a pool"):
        rops.rndmem_gather(pool, ph, 2048)
    with pytest.raises(ValueError, match="1-D"):
        rops.rndmem_gather(pool, ph.reshape(2, 4), 64)
    meta = (torch.empty(1024, device="meta"),
            torch.empty(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        rops.rndmem_gather(*meta, 64)


@pytest.mark.parametrize("n,seed", [(1000, 42), (4097, 7), (1, 0)])
def test_generate_uniform01_is_the_reference(n, seed):
    assert np.array_equal(tdata.generate_uniform01(n, seed),
                          jax_data.generate_uniform01(n, seed))


# -- the benchmark, end to end against the JAX package -------------------

@pytest.fixture
def jax_cfg(small_cfg):
    # 8 tracks x 64 samples, an 8 MiB pool; short loops so they wrap.
    return small_cfg.replace(impl="xla", rndmem_min_loop=100,
                             rndmem_max_loop=300)


def _pair(jax_cfg):
    jb = jax_create("RndMemRead", jax_cfg)
    jb.setup()
    pb = create_benchmark("RndMemRead", _port(jax_cfg), CPU)
    pb.setup()
    return jb, pb


def test_setup_generates_the_reference_data(jax_cfg):
    jb, pb = _pair(jax_cfg)
    assert np.array_equal(pb.host_pool, jb.host_pool)
    for k in ("playheads_start", "playheads_end", "playheads",
              "last_playheads"):
        assert np.array_equal(getattr(pb, k), getattr(jb, k)), k
    assert np.array_equal(pb.host_output, jb.host_output)
    assert pb.metadata() == jb.metadata()


def test_iterations_match_jax_and_wrap(jax_cfg):
    jb, pb = _pair(jax_cfg)
    wrapped = False
    for _ in range(6):
        jb.iterate()
        pb.iterate()
        assert np.array_equal(pb.host_output, jb.host_output)
        assert np.array_equal(pb.playheads, jb.playheads)
        wrapped |= bool((pb.playheads < pb.last_playheads).any())
    assert wrapped
    v = pb.validate()
    assert v.passed and v.max_error == 0.0
    assert jb.validate().passed


def test_load_state_resumes_a_jax_run(jax_cfg):
    jb = jax_create("RndMemRead", jax_cfg)
    jb.setup()
    jb.iterate()
    pb = create_benchmark("RndMemRead", _port(jax_cfg), CPU)
    pb.load_state(jb.host_pool, jb.playheads_start, jb.playheads_end,
                  jb.playheads)
    jb.iterate()
    assert np.array_equal(pb.host_output, jb.host_output)
    assert np.array_equal(pb.playheads, jb.playheads)


def test_stream_advances_the_playheads_on_the_device(jax_cfg):
    _, pb = _pair(jax_cfg)
    step, ph = pb.stream_body()
    host = pb.playheads.astype(np.int64)
    for _ in range(5):
        out = rops.rndmem_gather(pb._pool_dev, ph, pb.buffer_size)
        ph, p = step(ph)
        assert p.item() == pytest.approx(out.abs().mean().item())
        host = host + pb.buffer_size
        host = np.where(host >= pb.playheads_end, pb.playheads_start, host)
        assert ph.dtype == torch.int32
        assert np.array_equal(ph.numpy(), host)


def test_corrupted_output_fails_validation(jax_cfg):
    _, pb = _pair(jax_cfg)
    pb.host_output = pb.host_output.copy()
    pb.host_output[3] += 1e-5
    assert not pb.validate().passed


def test_benchmark_runs_through_the_runner(jax_cfg):
    cfg = _port(jax_cfg).replace(n_runs=2, warmup=1, pipeline_depth=4,
                                 saturated_reps=2, device_timing=True)
    b = create_benchmark("RndMemRead", cfg, CPU)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.validation.passed, res.validation.messages[:3]
    assert len(res.saturated_latencies) == 2
    assert res.device_timing_method == "wall"


def test_load_state_rejects_wrong_shapes(jax_cfg):
    pb = create_benchmark("RndMemRead", _port(jax_cfg), CPU)
    ph = np.zeros(8, np.int64)
    with pytest.raises(ValueError, match="pool"):
        pb.load_state(np.zeros(16, np.float32), ph, ph, ph)
    with pytest.raises(ValueError, match="playheads"):
        pb.load_state(np.zeros(4096, np.float32), ph, ph, ph[:4])


def test_cli_defaults_run_rndmem_on_the_cpu():
    """No --benchmark: RndMemRead at the CLI's 128 tracks (here with a
    1 MiB pool and few runs), as the reference's default."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--poolMiB", "1", "--nRuns", "3", "--warmup", "1",
                       "--pipelineDepth", "8", "--saturatedReps", "2",
                       "--json"], device="cpu")
    lines = buf.getvalue().splitlines()
    assert rc == 0, lines[-20:]
    rec = json.loads("\n".join(lines[lines.index("{"):-1]))
    assert rec["benchmark"] == "RndMemRead"
    assert rec["configuration"]["nTracks"] == 128
    assert rec["validation"]["status"] == "SUCCESS"
    assert rec["metadata"]["poolMiB"] == 1
