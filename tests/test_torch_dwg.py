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

The CUDA kernel cannot run here, so its arithmetic is emulated lane by
lane in NumPy from ``dwg_schedule``: its rails must be the golden's bit
for bit, and its mono order (``dwg_mono_in_order``) the twin's output
within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
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


# -- the CUDA kernel's schedule and arithmetic, emulated -----------------
#
# Edge lengths at S = 48: 1 (half 0, so bpos == cur), 2, S - 1, S, S + 1,
# 2S - 1 (the bwd window wraps), odd lengths, an out tap at or past S
# (70, 95), and rows whose in tap is their out tap (``SAME_TAP``).
EDGE = [1, 2, S - 1, S, S + 1, 2 * S - 1, 7, 33, 70, 13, 64, 3, 5, 100]
SAME_TAP = (3, 7, 10)  # rows given in_tap = out_tap


def _edge_inputs(rng, lengths, same_tap=SAME_TAP, s=S):
    lengths = np.array(lengths, np.int32)
    g = len(lengths)
    lmax = int(lengths.max()) + 3
    in_taps = (lengths // 4).astype(np.int32)
    out_taps = (3 * lengths // 4).astype(np.int32)
    in_taps[list(same_tap)] = out_taps[list(same_tap)]
    params = [lengths, in_taps, out_taps,
              (0.1 + 0.9 * rng.random(g, dtype=np.float32)).astype(np.float32),
              np.full(g, 0.99, np.float32), np.full(g, 0.9999, np.float32)]
    x = (rng.random(s, dtype=np.float32) * 2 - 1).astype(np.float32)
    fwd = (rng.random((g, lmax), dtype=np.float32) * 0.1).astype(np.float32)
    bwd = (rng.random((g, lmax), dtype=np.float32) * 0.1).astype(np.float32)
    return x, fwd, bwd, params


def _step(fv, bv, gain, refl, damp, inj, xn):
    """csrc/dwg.cu pair_step on float32 arrays; returns the contribution."""
    f, b = fv * damp, bv * damp
    xi = xn * gain
    f, b = np.where(inj, f + xi, f), np.where(inj, b + xi, b)
    return b * refl, f * refl, (f + b) * np.float32(0.5)


def _emulate(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp):
    """The kernel's rails, lane by lane: each update warp of the schedule
    walks its pairs as ``update_segment`` does, each mono lane its row's
    out-tap pair. Returns (fwd', bwd', steps), steps[g, p] the number of
    steps fwd cell p's pair took, and the count of times it was loaded."""
    fwd, bwd = fwd.copy(), bwd.copy()
    g_count, lmax = fwd.shape
    s = x.shape[0]
    sc = dops.dwg_schedule(g_count, s, lmax)
    steps = np.zeros((g_count, lmax), np.int64)
    owned = np.zeros((g_count, lmax), np.int64)
    lanes = np.arange(32)
    for blk in range(sc.update_blocks):
        for warp in range(dops.DWG_WARPS):
            row, start = sc.task(blk, warp)
            if row >= g_count:
                continue
            ln, it, ot = int(lengths[row]), int(in_taps[row]), int(out_taps[row])
            if not 1 <= ln <= lmax or start >= min(ln, s):
                continue
            base = start + lanes
            p = base[:, None] + 32 * np.arange(dops.DWG_PAIRS)[None, :]
            on = (p < min(ln, s)) & (p != ot)
            bp = (p + ln // 2) % ln
            fv = np.where(on, fwd[row, np.minimum(p, lmax - 1)], 0).astype(np.float32)
            bv = np.where(on, bwd[row, bp], 0).astype(np.float32)
            np.add.at(owned[row], p[on], 1)
            n = base.copy()
            while (n < s).any():
                nj = n[:, None] + 32 * np.arange(dops.DWG_PAIRS)[None, :]
                act = on & (nj < s)
                xn = x[np.minimum(nj, s - 1)]
                f2, b2, _ = _step(fv, bv, gains[row], refl[row], damp[row],
                                  p == it, xn)
                fv, bv = np.where(act, f2, fv), np.where(act, b2, bv)
                np.add.at(steps[row], p[act], 1)
                n += ln
            fwd[row, p[on]] = fv[on]
            bwd[row, bp[on]] = bv[on]
    for row in range(g_count):  # the mono groups' lanes
        ln, ot = int(lengths[row]), int(out_taps[row])
        if not (1 <= ln <= lmax and 0 <= ot < min(ln, s)):
            continue
        owned[row, ot] += 1
        bp = (ot + ln // 2) % ln
        fv, bv = fwd[row, ot], bwd[row, bp]
        for n in range(ot, s, ln):
            fv, bv, _ = _step(fv, bv, gains[row], refl[row], damp[row],
                              ot == in_taps[row], x[n])
            steps[row, ot] += 1
        fwd[row, ot], bwd[row, bp] = fv, bv
    return fwd, bwd, steps, owned


@settings(max_examples=40, deadline=None)
@given(g_count=st.integers(1, 40), s=st.integers(1, 140),
       lmax=st.integers(1, 160), seed=st.integers(0, 2 ** 31 - 1))
def test_dwg_schedule_covers_every_pair_once(g_count, s, lmax, seed):
    rng = np.random.Generator(np.random.MT19937(seed))
    lengths = rng.integers(1, lmax + 1, g_count).astype(np.int32)
    x, fwd, bwd = (np.zeros(s, np.float32), np.zeros((g_count, lmax), np.float32),
                   np.zeros((g_count, lmax), np.float32))
    params = [lengths, (lengths // 4).astype(np.int32),
              (3 * lengths // 4).astype(np.int32)] + [np.ones(g_count, np.float32)] * 3
    _, _, steps, owned = _emulate(x, fwd, bwd, *params)
    for row, ln in enumerate(lengths):
        touched = np.arange(lmax) < min(ln, s)
        assert (owned[row][touched] == 1).all() and (owned[row][~touched] == 0).all()
        p = np.arange(min(ln, s))
        assert np.array_equal(steps[row][:p.size], -(-(s - p) // ln))
        assert (steps[row][p.size:] == 0).all()
    # The longest chain any thread walks: D = ceil(S / min L).
    assert steps.max() == -(-s // int(lengths.min()))


@settings(max_examples=60, deadline=None)
@given(g_count=st.integers(1, 200_000), s=st.integers(1, 8192),
       lmax=st.integers(1, 8192))
def test_dwg_schedule_fits_cuda_limits(g_count, s, lmax):
    sc = dops.dwg_schedule(g_count, s, lmax)
    width, seg = min(lmax, s), 32 * dops.DWG_PAIRS
    assert (sc.segments - 1) * seg < width <= sc.segments * seg
    assert sc.groups * dops.DWG_GROUP >= g_count > (sc.groups - 1) * dops.DWG_GROUP
    assert sc.update_blocks * dops.DWG_WARPS >= g_count * sc.segments
    assert sc.task(sc.update_blocks - 1, dops.DWG_WARPS - 1)[0] >= g_count - 1
    assert 1 <= sc.grid <= 2 ** 31 - 1
    with pytest.raises(ValueError):
        dops.dwg_schedule(g_count, s, 0)


@pytest.mark.parametrize("case", ["edge", "unaligned", "pow2", "mixed"])
def test_kernel_emulation_is_the_golden_bit_for_bit(rng, case):
    if case == "edge":
        x, fwd, bwd, params = _edge_inputs(rng, EDGE)
    else:
        x, fwd, bwd, params = _inputs(rng, LENGTHS[case])
    f, b = fwd, bwd
    gf, gb = fwd, bwd
    for _ in range(2):  # chained
        f, b, _, _ = _emulate(x, f, b, *params)
        _, gf, gb = dwg_reference(x, gf, gb, *params)
        assert np.array_equal(f, gf) and np.array_equal(b, gb)
    assert not np.array_equal(f, fwd)


@pytest.mark.parametrize("ref,s", [("xla", S), ("xla", 2 * S - 1),
                                   ("arc", S)])
def test_kernel_emulation_matches_jax_scan_and_arc(rng, ref, s):
    """The arc form takes ceil(S / min L) rounds, so it sees the edge rows
    of length 7 and up (7 rounds)."""
    x, fwd, bwd, params = _edge_inputs(rng, EDGE, s=s)
    keep = np.argsort(params[0] < s, kind="stable")  # long rows first
    if ref == "arc":
        keep = keep[params[0][keep] >= 7]
    fwd, bwd, params = fwd[keep], bwd[keep], [p[keep] for p in params]
    f, b, _, _ = _emulate(x, fwd, bwd, *params)
    out = dops.dwg_mono_in_order(x, fwd, bwd, *params)
    lengths = params[0]
    if ref == "xla":
        r_out, r_f, r_b = jax_dwg_block(x, fwd, bwd, *params)
    else:
        r_out, r_f, r_b = dwg_block_arc(
            x, fwd, bwd, *params, n_long=int((lengths >= s).sum()),
            n_rounds=int(-(-s // int(lengths[lengths < s].min()))))
    np.testing.assert_allclose(f, np.asarray(r_f), atol=RAIL_ATOL, rtol=0)
    np.testing.assert_allclose(b, np.asarray(r_b), atol=RAIL_ATOL, rtol=0)
    np.testing.assert_allclose(out, np.asarray(r_out), atol=OUT_ATOL, rtol=0)
    assert np.abs(out).max() > 0.01


@pytest.mark.parametrize("g_count", [6, 200, 300])
def test_mono_order_matches_the_twin(rng, g_count):
    """Past one group (128 waveguides) and one warp, with out taps that
    collide on samples, so the butterfly and the group order both act."""
    lengths = np.resize(np.array(EDGE, np.int32), g_count)
    same = [i for i in range(g_count) if i % 14 in SAME_TAP]
    x, fwd, bwd, params = _edge_inputs(rng, lengths, same_tap=same)
    out = dops.dwg_mono_in_order(x, fwd, bwd, *params)
    want, _, _ = dops.dwg_block_plain(_t(x), _t(fwd), _t(bwd),
                                      *[_t(p) for p in params])
    g_out, _, _ = dwg_reference(x, fwd, bwd, *params)
    assert np.abs(out).max() > 0.01
    np.testing.assert_allclose(out, want.numpy(), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(out, g_out, atol=OUT_ATOL, rtol=0)


def test_mono_order_is_the_written_tree():
    """One sample, one waveguide a lane: the butterfly's tree, then the
    warps and the groups in order, checked on values whose float32 sums
    depend on the order."""
    g_count, s = 300, 1
    lengths = np.ones(g_count, np.int32)
    taps = np.zeros(g_count, np.int32)
    rng = np.random.Generator(np.random.MT19937(5))
    fwd = (10.0 ** rng.integers(-8, 8, (g_count, 1))).astype(np.float32)
    fwd *= np.where(rng.random((g_count, 1)) < 0.5, -1, 1).astype(np.float32)
    bwd = np.zeros_like(fwd)
    one = np.ones(g_count, np.float32)
    out = dops.dwg_mono_in_order(np.zeros(1, np.float32), fwd, bwd, lengths,
                                 taps - 1, taps, one, one, one)
    c = np.zeros(384, np.float32)
    c[:g_count] = (fwd[:, 0] + bwd[:, 0]) * np.float32(0.5)
    acc = np.float32(0)
    for grp in range(3):
        warp_sums = []
        for w in range(4):
            lane = list(c[grp * 128 + 32 * w: grp * 128 + 32 * w + 32])
            for off in (16, 8, 4, 2, 1):  # lane 0 of the xor butterfly
                lane = [np.float32(lane[i] + lane[i ^ off]) for i in range(32)]
            warp_sums.append(lane[0])
        gsum = warp_sums[0]
        for w in warp_sums[1:]:
            gsum = np.float32(gsum + w)
        acc = np.float32(acc + gsum)
    assert out.shape == (s,) and out[0] == acc
