"""The PyTorch port's overlapped-infeed tier (``harness/overlap.py``) and
the runner's overlap pass against the JAX package, on the CPU at toy
size. On the CPU both loops run the same synchronous copies; the card's
streams and events are held to the same equalities by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``."""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.harness import overlap as jax_overlap
from gpuaudiobench_tpu.harness.output import (
    generate_json_results as jax_json,
)
from gpuaudiobench_tpu.harness.runner import run_benchmark as jax_run
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import overlap
from gpuaudiobench_tpu_torch.harness.output import generate_json_results
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
OVERLAP_BENCHMARKS = ["gain", "GainStats", "FFT1D", "Conv1D", "Conv1D_accel",
                      "IIRFilter", "BiquadChain", "DWG1DNaive",
                      "datacopy5050"]
KNOBS = {"Conv1D": {"ir_length": 40}, "Conv1D_accel": {"ir_length": 40},
         "DWG1DNaive": {"dwg_min_length": 20, "dwg_max_length": 200},
         "datacopy5050": {"transfer_mib": 1}}


@pytest.fixture
def jax_cfg(small_cfg):
    return small_cfg.replace(overlap_depth=4, overlap_reps=2)


@pytest.fixture
def port_cfg(jax_cfg):
    return BenchConfig(**{f.name: getattr(jax_cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _bench(name, cfg, **knobs):
    b = create_benchmark(name, cfg.replace(**knobs), CPU)
    b.setup()
    return b


def _stateless():
    return (lambda x, c: (x * 2.0, c)), [np.ones(8, np.float32),
                                         np.zeros(8, np.float32)], ()


@pytest.mark.parametrize("blocks", [[], [np.ones(4, np.float32)]])
def test_measure_overlap_refuses_fewer_than_two_blocks(blocks):
    step, _, carry = _stateless()
    with pytest.raises(ValueError, match=">= 2 distinct"):
        overlap.measure_overlap(step, blocks, carry, 4, 2, CPU)


def test_infeed_refuses_blocks_of_two_shapes():
    with pytest.raises(ValueError, match="differ"):
        overlap.Infeed([np.ones(4, np.float32), np.ones(5, np.float32)], CPU)


@pytest.mark.parametrize("reps", [1, 3])
def test_measure_overlap_returns_reps_values_per_tier(reps):
    step, blocks, carry = _stateless()
    ser, ovl = overlap.measure_overlap(step, blocks, carry, 4, reps, CPU)
    assert len(ser) == len(ovl) == reps
    assert all(v > 0 for v in ser + ovl)


@pytest.mark.parametrize("depth", [1, 2, 7])
def test_loops_agree_on_a_stateful_body_and_match_the_jax_body(
        jax_cfg, port_cfg, depth):
    """IIRFilter's twin, state carried: both loops give the same last
    output and state, and the JAX package's overlap body run over the
    same blocks gives them within the benchmark's 1e-4."""
    b = _bench("IIRFilter", port_cfg)
    step, blocks, carry = b.overlap_body()
    infeed = overlap.Infeed(blocks, CPU)
    y_s, z_s = overlap.run_serial(infeed, step, carry.clone(), depth)
    y_o, z_o = overlap.run_overlapped(infeed, step, carry.clone(), depth)
    assert torch.equal(y_s, y_o) and torch.equal(z_s, z_o)
    assert torch.equal(carry, b._state_dev)  # the body never writes it

    ref = jax_create("IIRFilter", jax_cfg)
    ref.setup()
    f, jblocks, jstate = ref.overlap_body()
    for k in range(depth):
        jbuf, jstate = f(jnp.asarray(jblocks[k % 2]), jstate)
    # The JAX step returns the block and its state in one flat buffer.
    jy = np.asarray(jbuf)[:y_s.numel()].reshape(y_s.shape)
    np.testing.assert_allclose(y_s.numpy(), jy, atol=1e-4)
    np.testing.assert_allclose(z_s.numpy(), np.asarray(jstate), atol=1e-3)


def test_loops_agree_on_rails_updated_in_place(port_cfg):
    b = _bench("DWG1DNaive", port_cfg, **KNOBS["DWG1DNaive"])
    step, blocks, (fwd, bwd) = b.overlap_body()
    infeed = overlap.Infeed(blocks, CPU)
    got = [loop(infeed, step, (fwd.clone(), bwd.clone()), 5)
           for loop in (overlap.run_serial, overlap.run_overlapped)]
    (y_s, (f_s, b_s)), (y_o, (f_o, b_o)) = got
    assert torch.equal(y_s, y_o)
    assert torch.equal(f_s, f_o) and torch.equal(b_s, b_o)
    assert not torch.equal(f_s, fwd)  # the rails did ring


def test_measure_overlap_batched_rejects_a_ragged_depth():
    step, blocks, carry = _stateless()
    with pytest.raises(ValueError, match="multiple of"):
        overlap.measure_overlap_batched(step, blocks, carry, 6, 4, 2, CPU)


def test_measure_overlap_batched_returns_reps():
    step, blocks, carry = _stateless()
    out = overlap.measure_overlap_batched(step, blocks, carry, 8, 4, 3, CPU)
    assert len(out) == 3 and all(v > 0 for v in out)


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_groups_differ_where_the_reference_repeats(batch):
    """Two blocks and an even batch: the reference's two upload groups
    hold the same blocks (its ``overlap.py:155-158``); the port's
    differ, so every group upload is a real transfer."""
    a, b = np.full(3, 1.0, np.float32), np.full(3, -1.0, np.float32)
    seen = []

    def jax_step(x, c):
        seen.append(float(np.asarray(x)[0]))
        return x, c

    depth = 2 * batch
    jax_overlap.measure_overlap_batched(jax_step, [a, b], (), depth, batch,
                                        reps=1)
    run = seen[-depth:]
    assert run[:batch] == run[batch:]  # the reference's fault

    groups = overlap.batch_groups([a, b], batch)
    assert not np.array_equal(groups[0], groups[1])
    ours = []

    def step(x, c):
        ours.append(float(x[0]))
        return x, c

    infeed = overlap.Infeed(groups, CPU)
    overlap.run_batched(infeed, step, (), depth, batch)
    assert ours[:batch] != ours[batch:]
    assert sorted(set(ours)) == [-1.0, 1.0]


@pytest.mark.parametrize("name", OVERLAP_BENCHMARKS)
def test_overlap_pass_runs_and_validates(port_cfg, name):
    b = _bench(name, port_cfg, **KNOBS.get(name, {}))
    cfg = b.cfg
    r = run_benchmark(b, cfg, verbose=False)
    assert r.overlap_depth == 4
    assert len(r.overlap_latencies) == len(r.overlap_serial_latencies) == 2
    assert r.overlap_statistics.median > 0
    assert r.overlap_serial_statistics.median > 0
    assert r.validation.passed, r.validation.messages[:3]
    ov = generate_json_results(r, cfg, CPU)["overlapped"]
    assert ov["depth"] == 4 and ov["reps"] == 2
    assert ov["speedup_vs_serial"] == pytest.approx(
        ov["serial_p50_ms"] / ov["overlapped_p50_ms"])


def test_overlapped_section_has_the_reference_keys(jax_cfg, port_cfg):
    ref = jax_create("gain", jax_cfg)
    ref.setup()
    theirs = jax_json(jax_run(ref, jax_cfg, verbose=False), jax_cfg)
    b = _bench("gain", port_cfg)
    ours = generate_json_results(run_benchmark(b, port_cfg, verbose=False),
                                 port_cfg, CPU)
    assert set(ours["overlapped"]) == set(theirs["overlapped"])


def test_overlap_skipped_with_a_note_without_per_block_upload(port_cfg):
    b = _bench("ModalFilterBank", port_cfg)
    assert b.overlap_body() is None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = run_benchmark(b, port_cfg, verbose=True)
    assert ("Note: ModalFilterBank has no per-block input upload; "
            "skipping overlapped-infeed pass.") in buf.getvalue()
    assert r.overlap_statistics is None
    assert "overlapped" not in generate_json_results(r, port_cfg, CPU)


def test_overlap_off_by_default(small_cfg):
    cfg = BenchConfig(**{f.name: getattr(small_cfg, f.name)
                         for f in dataclasses.fields(BenchConfig)})
    b = _bench("gain", cfg)
    r = run_benchmark(b, cfg, verbose=False)
    assert r.overlap_statistics is None and r.overlap_depth == 0
