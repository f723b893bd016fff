"""PyTorch port's modal ops against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas kernels run in interpret mode, as tests/test_pallas_ops.py runs
them. Tolerance: max|port - reference| <= 1e-5 * max|reference| for
outputs (the f32 sums are taken in another order, and the Pallas path
folds amp into the state before rotating); 1e-6 absolute for states,
whose magnitude is below sqrt(2).
"""

import numpy as np
import pytest
import torch
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
    launches = tops.KERNEL_LAUNCHES
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
