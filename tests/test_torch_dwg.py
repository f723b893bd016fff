"""DWG1DNaive / DWG1DAccel in the PyTorch port (the waveguide block's plain
twin and the benchmark) against the JAX package, on the CPU at toy size.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas one-hot kernel runs in interpret mode, as tests/test_pallas_ops.py
runs it. Every kernel-vs-twin check starts from random non-zero rails
(U(0, 0.1)), because the output tap pair of a waveguide never receives
energy from silence (the output is structurally zero; models/dwg.py).
Tolerances, absolute: outputs 1e-5 and rails 1e-6 against the JAX
``dwg_block``, ``dwg_block_pallas`` and ``dwg_block_arc`` (the
reference's own bars, tests/test_pallas_ops.py:137-139); the benchmark's
rails against the JAX benchmark's 1e-6 (each rail cell is the same chain
of float32 products and sums); the golden bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.models.dwg import dwg_reference as jax_reference
from gpuaudiobench_tpu.ops.dwg import dwg_block as jax_dwg_block
from gpuaudiobench_tpu.ops.dwg_arc import dwg_block_arc
from gpuaudiobench_tpu.ops.dwg_pallas import dwg_block_pallas
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models.dwg import PARAMS, dwg_reference
from gpuaudiobench_tpu_torch.ops import dwg as dops
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
OUT_ATOL = 1e-5
RAIL_ATOL = 1e-6
N_BLOCKS = 3
# The unaligned lengths of tests/test_pallas_ops.py, and powers of two
# (DWG1DAccel's), some at least the block (S = 48), some below it.
LENGTHS = {
    "unaligned": [5, 8, 12, 16, 33, 40],
    "pow2": [4, 8, 16, 32, 64, 128, 256],
    "mixed": [100, 7, 48, 49, 64, 13, 200, 47],
}
S = 48


def _inputs(rng, lengths):
    """Partitioned long-first (the arc form needs it), U(0, 0.1) rails."""
    lengths = np.array(lengths, np.int32)
    lengths = lengths[np.argsort(lengths < S, kind="stable")]
    g = len(lengths)
    lmax = int(lengths.max()) + 3  # a row pitch above every length
    params = [lengths, (lengths // 4).astype(np.int32),
              (3 * lengths // 4).astype(np.int32),
              rng.random(g, dtype=np.float32),
              np.full(g, 0.99, np.float32), np.full(g, 0.9999, np.float32)]
    x = (rng.random(S, dtype=np.float32) * 2 - 1).astype(np.float32)
    fwd = (rng.random((g, lmax), dtype=np.float32) * 0.1).astype(np.float32)
    bwd = (rng.random((g, lmax), dtype=np.float32) * 0.1).astype(np.float32)
    return x, fwd, bwd, params


def _arc_statics(lengths):
    n_long = int((lengths >= S).sum())
    shorts = lengths[lengths < S]
    return n_long, (int(-(-S // int(shorts.min()))) if shorts.size else 0)


def _t(a):
    """A tensor holding a copy of a (the port's DWG updates rails in place)."""
    return torch.from_numpy(np.array(a))


def _chain(fn, x, fwd, bwd, params):
    outs = []
    for _ in range(N_BLOCKS):
        out, fwd, bwd = fn(x, fwd, bwd, *params)
        outs.append(np.asarray(out))
    return outs, np.asarray(fwd), np.asarray(bwd)


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_twin_matches_jax_scan_pallas_and_arc(rng, case):
    x, fwd, bwd, params = _inputs(rng, LENGTHS[case])
    ours = _chain(lambda *a: dops.dwg_block_plain(*a), _t(x), _t(fwd),
                  _t(bwd), [_t(p) for p in params])
    n_long, n_rounds = _arc_statics(params[0])
    refs = {"xla": _chain(jax_dwg_block, x, fwd, bwd, params),
            "arc": _chain(lambda *a: dwg_block_arc(
                *a, n_long=n_long, n_rounds=n_rounds), x, fwd, bwd, params)}
    with pltpu.force_tpu_interpret_mode():
        refs["pallas"] = _chain(dwg_block_pallas, x, fwd, bwd, params)
    for name, (outs, f, b) in refs.items():
        for got, want in zip(ours[0], outs):
            np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=0,
                                       err_msg=name)
        np.testing.assert_allclose(ours[1], f, atol=RAIL_ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(ours[2], b, atol=RAIL_ATOL, rtol=0,
                                   err_msg=name)
    assert np.abs(ours[1]).max() > 0.01  # the rails carry energy


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_twin_is_the_golden_bit_for_bit(rng, case):
    x, fwd, bwd, params = _inputs(rng, LENGTHS[case])
    out, f, b = dops.dwg_block_plain(_t(x), _t(fwd), _t(bwd),
                                     *[_t(p) for p in params])
    g_out, g_f, g_b = dwg_reference(x, fwd, bwd, *params)
    assert np.array_equal(f.numpy(), g_f) and np.array_equal(b.numpy(), g_b)
    np.testing.assert_allclose(out.numpy(), g_out, atol=OUT_ATOL, rtol=0)


def test_golden_is_the_reference_golden(rng):
    x, fwd, bwd, params = _inputs(rng, LENGTHS["mixed"])
    for a, b in zip(dwg_reference(x, fwd, bwd, *params),
                    jax_reference(x, fwd, bwd, *params)):
        assert np.array_equal(a, b)


def test_wrapper_on_cpu_is_the_twin_and_keeps_its_inputs(rng):
    x, fwd, bwd, params = _inputs(rng, LENGTHS["unaligned"])
    """The rails are updated in place; a caller keeps its starting rails
    by passing clones."""
    args = [_t(x), _t(fwd), _t(bwd)] + [_t(p) for p in params]
    launches = dict(dops.KERNEL_LAUNCHES)
    want = dops.dwg_block_plain(args[0], args[1].clone(), args[2].clone(),
                                *args[3:])
    assert np.array_equal(args[1].numpy(), fwd)  # the clones were written
    got = dops.dwg_block(*args)
    assert got[1] is args[1] and got[2] is args[2]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not np.array_equal(args[1].numpy(), fwd)
    assert dops.KERNEL_LAUNCHES == launches


def test_wrapper_rejects_bad_input(rng):
    x, fwd, bwd, params = _inputs(rng, LENGTHS["unaligned"])
    args = [_t(x), _t(fwd), _t(bwd)] + [_t(p) for p in params]
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(TypeError, match="lengths must be torch.int32"):
        dops.dwg_block(*bad)
    bad = list(args)
    bad[6] = bad[6][:3]
    with pytest.raises(ValueError, match="3 entries for 6 waveguides"):
        dops.dwg_block(*bad)
    bad = list(args)
    bad[2] = bad[2][:, :10]
    with pytest.raises(ValueError, match="differ"):
        dops.dwg_block(*bad)
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        dops.dwg_block(*meta)


# -- the benchmarks, end to end against the JAX package ------------------

@pytest.fixture
def jax_cfg(small_cfg):
    # 16 waveguides x 64 samples; lengths 20-200, so many wrap in a block.
    return small_cfg.replace(impl="xla", n_tracks=16, dwg_min_length=20,
                             dwg_max_length=200)


def _port(cfg):
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _pair(jax_cfg, name):
    jb = jax_create(name, jax_cfg)
    jb.setup()
    pb = create_benchmark(name, _port(jax_cfg), CPU)
    pb.setup()
    return jb, pb


def _same_state(jb, pb):
    np.testing.assert_allclose(pb.host_output, np.asarray(jb.host_output),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(pb.host_fwd, jb.host_fwd, atol=RAIL_ATOL, rtol=0)
    np.testing.assert_allclose(pb.host_bwd, jb.host_bwd, atol=RAIL_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["DWG1DNaive", "DWG1DAccel"])
def test_setup_generates_the_reference_data(jax_cfg, name):
    jb, pb = _pair(jax_cfg, name)
    for k in PARAMS:
        assert np.array_equal(getattr(pb, k), getattr(jb, k)), k
    assert np.array_equal(pb.host_input, jb.host_input)
    long_rows = pb.lengths >= pb.buffer_size
    assert not (~long_rows[:-1] & long_rows[1:]).any()  # long rows first
    if name == "DWG1DAccel":
        assert all(int(v) & (int(v) - 1) == 0 for v in pb.lengths)
    assert pb.metadata() == jb.metadata()
    _same_state(jb, pb)


@pytest.mark.parametrize("name", ["DWG1DNaive", "DWG1DAccel"])
def test_iterations_match_jax(jax_cfg, name):
    jb, pb = _pair(jax_cfg, name)
    for _ in range(3):
        jb.iterate()
        pb.iterate()
        _same_state(jb, pb)
    assert np.abs(pb.host_fwd).max() > 0.01
    v = pb.validate()
    assert v.passed, v.messages[:3]
    assert jb.validate().passed
    assert pb._invocations == jb._invocations == 4


def test_load_state_resumes_from_jax_rails(jax_cfg):
    jb = jax_create("DWG1DNaive", jax_cfg)
    jb.setup()
    jb.iterate()
    pb = create_benchmark("DWG1DNaive", _port(jax_cfg), CPU)
    pb.load_state(jb.host_input, {k: getattr(jb, k) for k in PARAMS},
                  jb.host_fwd, jb.host_bwd)
    jb.iterate()
    _same_state(jb, pb)
    pb.iterate()
    assert pb.validate().passed  # the golden starts from the JAX rails


def test_stream_step_is_the_iteration(jax_cfg):
    _, pb = _pair(jax_cfg, "DWG1DNaive")
    step, carry = pb.stream_body()
    carry, p = step(carry)
    pb.iterate()
    assert np.array_equal(carry[1].numpy(), pb.host_fwd)
    assert np.array_equal(carry[2].numpy(), pb.host_bwd)
    assert p.item() == pytest.approx(float(np.abs(pb.host_output).mean()))


@pytest.mark.parametrize("rail", ["host_output", "host_fwd", "host_bwd"])
def test_corrupted_result_fails_validation(jax_cfg, rail):
    _, pb = _pair(jax_cfg, "DWG1DAccel")
    bad = getattr(pb, rail).copy()
    bad.ravel()[7] += 0.05
    setattr(pb, rail, bad)
    assert not pb.validate().passed


@pytest.mark.parametrize("name", ["DWG1DNaive", "DWG1DAccel"])
def test_benchmark_runs_through_the_runner(jax_cfg, name):
    cfg = _port(jax_cfg).replace(n_runs=2, warmup=1, pipeline_depth=4,
                                 saturated_reps=2, device_timing=True)
    b = create_benchmark(name, cfg, CPU)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.validation.passed, res.validation.messages[:3]
    assert len(res.saturated_latencies) == 2
    assert res.device_timing_method == "wall"


def test_load_state_rejects_lengths_past_the_rails(jax_cfg):
    jb = jax_create("DWG1DNaive", jax_cfg)
    jb.setup()
    pb = create_benchmark("DWG1DNaive", _port(jax_cfg), CPU)
    params = {k: getattr(jb, k) for k in PARAMS}
    params["lengths"] = params["lengths"].copy()
    params["lengths"][0] = 201
    with pytest.raises(ValueError, match="lengths"):
        pb.load_state(jb.host_input, params, jb.host_fwd, jb.host_bwd)
    with pytest.raises(ValueError, match="rails"):
        pb.load_state(jb.host_input, {k: getattr(jb, k) for k in PARAMS},
                      jb.host_fwd[:, :10], jb.host_bwd)
