"""The Gordon-Smith resonator form of the modal bank, and output-track
counts that do not divide 32, in the PyTorch port against the JAX
package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas resonator kernel runs in interpret mode, as
tests/test_pallas_ops.py runs it. Tolerances: outputs max|port - ref| <=
1e-5 * max|ref| (f32 sums in another order; the reference's bar for the
resonator against its golden, tests/test_pallas_ops.py:432); res_init
1e-6 absolute (the same f32 op order). Resonator states against the
Pallas kernel in interpret mode: 1e-5 absolute, because XLA's CPU
backend contracts the shears into FMAs and drifts up to ~4e-6 from the
exact f32 sequence in 32 samples, while the port's twin (and its CUDA
kernel, which rounds each multiply and add on its own) gives that
sequence's bits (``test_res_twin_is_the_golden_f32_sequence``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.models.modal import (
    ModalFilterBankBenchmark as JaxModal,
    modal_reference_gs as jax_reference_gs,
)
from gpuaudiobench_tpu.ops.modal_pallas import (
    modal_bank_pallas,
    modal_res_step as jax_res_step,
    res_init as jax_res_init,
    stream_tile,
)
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.models.modal import (
    ModalFilterBankBenchmark,
    modal_reference_gs,
)
from gpuaudiobench_tpu_torch.ops import modal as tops

CPU = torch.device("cpu")
OUT_RTOL = 1e-5
STATE_ATOL = 1e-6
RES_STATE_ATOL = 1e-5


def _tables(rng, m):
    amp = rng.random(m, dtype=np.float32)
    w = 2 * np.pi * rng.random(m, dtype=np.float32) * 0.45
    cw, sw = np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)
    re = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    im = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    return amp, cw, sw, re, im


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_out_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= OUT_RTOL * np.abs(ref).max(), err


def test_res_init_matches_jax(rng):
    amp, cw, sw, re, im = _tables(rng, 4096)
    ours = tops.res_init(*_t(cw, sw, amp * re, amp * im))
    theirs = jax_res_init(cw, sw, amp * re, amp * im)
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=STATE_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("m,s,t_out", [(4096, 32, 32), (256, 32, 8),
                                       (2048, 64, 16)])
def test_res_step_chained_matches_pallas_interpret(rng, m, s, t_out):
    amp, cw, sw, re, im = _tables(rng, m)
    eps, y0, q0 = jax_res_init(cw, sw, amp * re, amp * im)
    eps, y0, q0 = (np.asarray(a) for a in (eps, y0, q0))
    tile = stream_tile(m, t_out)
    with pltpu.force_tpu_interpret_mode():
        ref1, jy, jq = jax_res_step(eps, y0, q0, s, t_out, tile)
        ref2, jy, jq = jax_res_step(eps, jy, jq, s, t_out, tile)
    te, py, pq = _t(eps, y0, q0)
    out1, py, pq = tops.modal_res_step(te, py, pq, s, t_out)
    out2, py, pq = tops.modal_res_step(te, py, pq, s, t_out)
    assert out1.shape == (s, t_out)
    _assert_out_close(out1.numpy(), ref1)
    _assert_out_close(out2.numpy(), ref2)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy),
                               atol=RES_STATE_ATOL)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq),
                               atol=RES_STATE_ATOL)


def test_res_twin_is_the_golden_f32_sequence(rng):
    """Per mode, the twin's shears are modal_reference_gs's f32 sequence,
    q = q - eps*y, y = y + eps*q, each op rounded on its own."""
    amp, cw, sw, re, im = _tables(rng, 2048)
    eps, y, q = (a.numpy() for a in tops.res_init(*_t(cw, sw, amp * re,
                                                       amp * im)))
    _, ty, tq = tops.modal_res_step_plain(*_t(eps, y, q), 64, 16)
    for _ in range(64):
        q = (q - eps * y).astype(np.float32)
        y = (y + eps * q).astype(np.float32)
    assert np.array_equal(ty.numpy(), y) and np.array_equal(tq.numpy(), q)


@pytest.mark.parametrize("m,s,t_out", [(1024, 64, 32), (3000, 64, 12),
                                       (999, 32, 3)])
def test_res_bank_meets_the_gs_golden(rng, m, s, t_out):
    tabs = _tables(rng, m)
    ref = modal_reference_gs(*tabs, s, t_out)
    launches = dict(tops.KERNEL_LAUNCHES)
    out, re_o, im_o = tops.modal_bank(*_t(*tabs), s, t_out, algorithm="res")
    assert out.shape == (t_out, s)
    _assert_out_close(out.numpy(), ref)
    assert tops.KERNEL_LAUNCHES == launches  # the twin, on the CPU


def test_res_bank_matches_pallas_interpret(rng):
    m, s, t_out = 1024, 64, 32
    tabs = _tables(rng, m)
    with pltpu.force_tpu_interpret_mode():
        ref, _, _ = modal_bank_pallas(*tabs, s, t_out, algorithm="res")
    out, _, _ = tops.modal_bank(*_t(*tabs), s, t_out, algorithm="res")
    _assert_out_close(out.numpy(), ref)


@pytest.mark.parametrize("m,s,t_out", [(1024, 64, 32), (2040, 16, 12)])
def test_gs_golden_is_the_reference_golden(rng, m, s, t_out):
    tabs = _tables(rng, m)
    assert np.array_equal(modal_reference_gs(*tabs, s, t_out),
                          jax_reference_gs(*tabs, s, t_out))


def test_res_bank_returns_its_input_states(rng):
    tabs = _t(*_tables(rng, 256))
    _, re_o, im_o = tops.modal_bank(*tabs, 16, 8, algorithm="res")
    assert re_o is tabs[3] and im_o is tabs[4]
    plain, re_p, im_p = tops.modal_bank_plain(*tabs, 16, 8, algorithm="res")
    assert re_p is tabs[3] and im_p is tabs[4]


def test_invalid_algorithm_raises(rng):
    with pytest.raises(ValueError, match="algorithm"):
        tops.modal_bank(*_t(*_tables(rng, 64)), 8, 8, algorithm="chebyshev")


@pytest.mark.parametrize("m,t_out", [(3000, 12), (999, 3), (960, 64)])
def test_rotation_with_tracks_not_dividing_32_matches_jax(rng, m, t_out):
    """T_out that does not divide 32 (or exceeds it): the JAX package
    answers through its XLA scan (modal_pallas.py:252-259)."""
    tabs = _tables(rng, m)
    with pltpu.force_tpu_interpret_mode():
        ref, _, _ = modal_bank_pallas(*tabs, 32, t_out)
    out, _, _ = tops.modal_bank(*_t(*tabs), 32, t_out)
    _assert_out_close(out.numpy(), ref)


def test_modal_benchmark_at_12_tracks_matches_jax(small_cfg):
    """ModalFilterBank sets T_out = min(nTracks, 32): 12 tracks give
    T_out 12, which the port's CUDA kernel once refused."""
    cfg = small_cfg.replace(n_tracks=12, impl="xla")
    jb = JaxModal(cfg)
    jb.setup()
    pb = ModalFilterBankBenchmark(BenchConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(BenchConfig)}), CPU)
    pb.load_params(jb.params)
    assert pb.output_tracks == 12
    _assert_out_close(pb.host_output, np.asarray(jb.host_output))
    assert pb.validate().passed
