"""PyTorch port's modal ops against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas kernels run in interpret mode, as tests/test_pallas_ops.py runs
them. Tolerance: max|port - reference| <= 1e-5 * max|reference| for
outputs (the f32 sums are taken in another order, and the Pallas path
folds amp into the state before rotating); 1e-6 absolute for states,
whose magnitude is below sqrt(2). The CUDA kernel's static schedule and
its summation order (emulated in numpy) are checked here too.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.ops.modal import modal_bank_xla
from gpuaudiobench_tpu.ops.modal_pallas import (
    modal_bank_pallas,
    modal_folded_step as jax_folded_step,
    stream_tile,
)
from gpuaudiobench_tpu_torch.ops import modal as tops

S = 32
OUT_RTOL = 1e-5
STATE_ATOL = 1e-6
SHAPES = [(4096, 32), (960, 32), (256, 8)]


def _tables(rng, m):
    amp = rng.random(m, dtype=np.float32)
    w = 2 * np.pi * rng.random(m, dtype=np.float32) * 0.45
    cw, sw = np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)
    re = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    im = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    return amp, cw, sw, re, im


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_out_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    peak = np.abs(ref).max()
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= OUT_RTOL * peak, (err, peak)


@pytest.mark.parametrize("m,t_out", SHAPES)
def test_modal_bank_plain_matches_xla(rng, m, t_out):
    tabs = _tables(rng, m)
    ref, rre, rim = modal_bank_xla(*tabs, S, t_out)
    out, re2, im2 = tops.modal_bank_plain(*_t(*tabs), S, t_out)
    assert out.shape == (t_out, S)
    _assert_out_close(out.numpy(), ref)
    np.testing.assert_allclose(re2.numpy(), np.asarray(rre), atol=STATE_ATOL)
    np.testing.assert_allclose(im2.numpy(), np.asarray(rim), atol=STATE_ATOL)


@pytest.mark.parametrize("m,t_out", SHAPES)
def test_modal_bank_plain_matches_pallas_interpret(rng, m, t_out):
    tabs = _tables(rng, m)
    with pltpu.force_tpu_interpret_mode():
        ref, _, _ = modal_bank_pallas(*tabs, S, t_out)
    out, _, _ = tops.modal_bank_plain(*_t(*tabs), S, t_out)
    _assert_out_close(out.numpy(), ref)


@pytest.mark.parametrize("m,t_out", SHAPES)
def test_modal_bank_wrapper_on_cpu_keeps_pallas_contract(rng, m, t_out):
    """On CPU tensors the wrapper runs the plain twin and, like
    modal_bank_pallas, returns the input states themselves."""
    tabs = _t(*_tables(rng, m))
    out, re_o, im_o = tops.modal_bank(*tabs, S, t_out)
    assert re_o is tabs[3] and im_o is tabs[4]
    plain, _, _ = tops.modal_bank_plain(*tabs, S, t_out)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("m,t_out", [(4096, 32), (256, 8)])
def test_folded_step_chained_matches_pallas_interpret(rng, m, t_out):
    amp, cw, sw, re, im = _tables(rng, m)
    re_f, im_f = amp * re, amp * im
    tile = stream_tile(m, t_out)
    with pltpu.force_tpu_interpret_mode():
        ref1, jre, jim = jax_folded_step(cw, sw, re_f, im_f, S, t_out, tile)
        ref2, jre, jim = jax_folded_step(cw, sw, jre, jim, S, t_out, tile)
    c, s_, pre, pim = _t(cw, sw, re_f, im_f)
    out1, pre, pim = tops.modal_folded_step_plain(c, s_, pre, pim, S, t_out)
    out2, pre, pim = tops.modal_folded_step_plain(c, s_, pre, pim, S, t_out)
    assert out1.shape == (S, t_out)
    _assert_out_close(out1.numpy(), ref1)
    _assert_out_close(out2.numpy(), ref2)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jre), atol=STATE_ATOL)
    np.testing.assert_allclose(pim.numpy(), np.asarray(jim), atol=STATE_ATOL)


@pytest.mark.parametrize("m,t_out", [(4096, 32), (960, 32), (256, 8)])
def test_folded_wrapper_on_cpu_is_the_plain_twin(rng, m, t_out):
    amp, cw, sw, re, im = _tables(rng, m)
    args = _t(cw, sw, amp * re, amp * im)
    launches = dict(tops.KERNEL_LAUNCHES)
    got = tops.modal_folded_step(*args, S, t_out)
    want = tops.modal_folded_step_plain(*args, S, t_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tops.KERNEL_LAUNCHES == launches  # no kernel ran on the CPU


def test_folded_plain_matches_unfolded_bank(rng):
    """The streaming step on amp-prefolded states synthesizes the same
    block as the round-trip bank on the raw states."""
    m, t_out = 2048, 16
    amp, cw, sw, re, im = _tables(rng, m)
    bank, _, _ = tops.modal_bank_plain(*_t(amp, cw, sw, re, im), S, t_out)
    step, _, _ = tops.modal_folded_step_plain(
        *_t(cw, sw, amp * re, amp * im), S, t_out)
    _assert_out_close(step.numpy().T, bank.numpy())


# -- the CUDA kernel's static schedule (ops/modal.py: modal_schedule) ------
#
# The kernel takes its grid, passes and modes a thread from this host-side
# function; each tile's modes come from ModalSchedule.tile_modes, as the
# kernel computes them.

@st.composite
def _schedule_case(draw):
    t_out = draw(st.sampled_from([1, 2, 3, 8, 12, 16, 32, 48, 64]))
    m = t_out * draw(st.integers(1, 6000 // t_out))
    capacity = draw(st.integers(1, 200))
    warps = draw(st.sampled_from([1, 2, 4, 8, 16]))
    mpt = draw(st.sampled_from([1, 2, 4, 8, 16, 21]))
    return m, t_out, capacity, warps, mpt


@settings(max_examples=150, deadline=None)
@given(_schedule_case())
def test_schedule_covers_every_mode_once_balanced(case):
    m, t_out, capacity, warps, max_mpt = case
    sch = tops.modal_schedule(m, t_out, capacity, warps, max_mpt)
    assert 1 <= sch.grid <= min(capacity, sch.tiles)
    assert sch.row_w % 32 == 0 and sch.row_w % t_out == 0
    assert sch.modes_per_thread <= max_mpt
    seen = np.zeros(m, dtype=np.int64)
    counts = []
    for b in range(sch.grid):
        lo, hi = sch.block_tiles(b)
        counts.append(hi - lo)
        # Every tile of the block falls in one of its passes, one a warp.
        assert hi - lo <= sch.passes * warps
        for tile in range(lo, hi):
            modes = np.array(sch.tile_modes(tile))
            for lane_modes in modes:
                real = lane_modes[lane_modes >= 0]
                # A thread's modes all fold onto one track.
                assert len(set((real % t_out).tolist())) <= 1
                seen[real] += 1
    assert (seen == 1).all()
    # Balanced to within one warp tile, no block without work, no idle pass.
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1
    assert (sch.passes - 1) * warps < max(counts)
    assert sch.n_partials == sch.grid * sch.passes


def test_schedule_at_the_main_shape():
    """1,048,576 modes onto 32 tracks on 132 SMs of one block of 12
    rotation warps each, at most 21 modes a thread: 21, one pass, 132
    partials (8.25 MiB); the multi-pass shape takes 4; ModalFilterBank's
    12,288 modes halve down to one mode a thread to spread over the
    card."""
    main = tops.modal_schedule(1048576, 32, 132, 12, 21)
    assert (main.modes_per_thread, main.tiles, main.grid, main.passes) == (
        21, 1561, 132, 1)
    assert tops.modal_schedule(4194304, 32, 132, 12, 21).passes == 4
    small = tops.modal_schedule(12288, 12, 132, 12, 21)
    assert (small.modes_per_thread, small.row_w, small.grid) == (1, 96, 132)
    mid = tops.modal_schedule(131072, 32, 132, 12, 21)
    assert (mid.modes_per_thread, mid.tiles) == (5, 820)
    with pytest.raises(ValueError):
        tops.modal_schedule(100, 12, 132, 12, 21)


def _emulate_kernel(cw, sw, re, im, s, t_out, sch):
    """The CUDA kernel's summation order in numpy f32: per sample, each
    thread sums its modes in row order; each (block, pass) partial sums,
    per track, the warps in order and each warp's lanes of that track in
    order; the partials are summed in (block, pass) order. The rotation
    takes the twin's separate multiplies (the kernel contracts them into
    FMAs, which only the card shows)."""
    threads, folds = [], []  # threads: mode rows; folds: per partial, per track
    for b in range(sch.grid):
        lo, hi = sch.block_tiles(b)
        for p in range(sch.passes):
            order = [[] for _ in range(t_out)]
            for tile in range(lo + p * sch.warps,
                              min(hi, lo + (p + 1) * sch.warps)):
                col = tile % (sch.row_w // 32)
                for lane, modes in enumerate(sch.tile_modes(tile)):
                    order[(32 * col + lane) % t_out].append(len(threads))
                    threads.append(modes)
            folds.append(order)
    idx = np.array(threads)
    valid = idx >= 0
    idx = np.where(valid, idx, 0)
    re, im = re.copy(), im.copy()
    out = np.zeros((s, t_out), np.float32)
    for n in range(s):
        re, im = re * cw - im * sw, re * sw + im * cw
        acc = np.zeros(len(idx), np.float32)
        for k in range(idx.shape[1]):
            acc = acc + np.where(valid[:, k], re[idx[:, k]], np.float32(0))
        total = np.zeros(t_out, np.float32)
        for order in folds:
            part = np.zeros(t_out, np.float32)
            for t, members in enumerate(order):
                for i in members:
                    part[t] = part[t] + acc[i]
            total = total + part
        out[n] = total
    return out, re, im


@pytest.mark.parametrize("m,t_out,capacity,warps,mpt", [
    (4096, 32, 3, 4, 4),     # blocks of 10 and 11 tiles in 3 passes
    (1024, 8, 3, 2, 4),      # 4 lanes a track; the last pass part empty
    (3000, 12, 5, 2, 2),     # W = 96: three column groups, 5 passes
    (999, 3, 132, 16, 16),   # fewer tiles than SMs, ragged rows
    (960, 32, 2, 1, 16),     # one warp a block, the last tile ragged
])
def test_kernel_summation_order_matches_twin_and_pallas(rng, m, t_out,
                                                        capacity, warps, mpt):
    amp, cw, sw, re, im = _tables(rng, m)
    re_f, im_f = amp * re, amp * im
    sch = tops.modal_schedule(m, t_out, capacity, warps, mpt)
    got, gre, gim = _emulate_kernel(cw, sw, re_f, im_f, S, t_out, sch)
    plain, pre, pim = tops.modal_folded_step_plain(*_t(cw, sw, re_f, im_f),
                                                   S, t_out)
    _assert_out_close(got, plain.numpy())
    np.testing.assert_allclose(gre, pre.numpy(), atol=STATE_ATOL)
    np.testing.assert_allclose(gim, pim.numpy(), atol=STATE_ATOL)
    # The JAX package's own path for the shape: the Pallas kernel where
    # its lane fold takes it, else its XLA scan.
    tile = stream_tile(m, t_out)
    if tile is None:
        ref, _, _ = modal_bank_xla(np.ones_like(cw), cw, sw, re_f, im_f, S,
                                   t_out)
        ref = np.asarray(ref).T
    else:
        with pltpu.force_tpu_interpret_mode():
            ref, _, _ = jax_folded_step(cw, sw, re_f, im_f, S, t_out, tile)
    _assert_out_close(got, ref)
