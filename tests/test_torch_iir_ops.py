"""The IIR ops of the PyTorch port against the JAX package, on the CPU.

Every plain twin of ``gpuaudiobench_tpu_torch/ops/iir.py`` runs on the
same numpy inputs (made from a seed) as the JAX function it stands in for
and as the Pallas kernel its CUDA kernel replaces, the latter under
``pltpu.force_tpu_interpret_mode()`` as ``tests/test_pallas_ops.py`` runs
it, with the state chained over 3 blocks.

Tolerances, absolute:

* the scan twin vs ``iir_biquad_xla`` and ``iir_biquad_pallas``: 1e-6
  (the same f32 recurrence in the same op order; XLA may contract it);
* the blockstate twin vs ``iir_biquad_blockstate`` and
  ``iir_biquad_blockstate_pallas``: 1e-5, the reference's own bar for the
  block-state form (its chunk products sum in another order);
* the cascade twin vs ``iir_cascade_pallas`` (systolic) and
  ``iir_cascade_pallas_chain``: 1e-5, as ``tests/test_pallas_ops.py``
  holds the systolic kernel against the chained scans.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.ops import iir as jiir
from gpuaudiobench_tpu.utils.data import biquad_lowpass_coefficients
from gpuaudiobench_tpu_torch.ops import iir as tiir

SCAN_ATOL = 1e-6
BLOCKSTATE_ATOL = 1e-5
CASCADE_ATOL = 1e-5
N_BLOCKS = 3


def _signal(rng, tracks, s):
    return (rng.random((tracks, s), dtype=np.float32) * 2 - 1).astype(
        np.float32)


def _coeffs(k=None, fc=0.25):
    if k is None:
        return np.array(biquad_lowpass_coefficients(fc), np.float32)
    return np.array([biquad_lowpass_coefficients(fc - 0.0125 * i)
                     for i in range(k)], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chain(fn, x, state, blocks=N_BLOCKS):
    """Run ``fn(x, state) -> (y, state')`` over ``blocks`` chained blocks of
    the same input; returns the last (y, state') as numpy arrays."""
    y = None
    for _ in range(blocks):
        y, state = fn(x, state)
    return np.asarray(y), np.asarray(state)


def _assert_pair(got, want, atol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("tracks,s,fc", [(8, 64, 0.25), (16, 32, 0.1),
                                         (8, 128, 0.4)])
def test_scan_twin_matches_xla_and_pallas(rng, tracks, s, fc):
    x = _signal(rng, tracks, s)
    c = _coeffs(fc=fc)
    z0 = (rng.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)
    ours = _chain(lambda xx, z: tiir.iir_biquad_plain(xx, _t(c), z),
                  _t(x), _t(z0))
    xla = _chain(lambda xx, z: jiir.iir_biquad_xla(xx, c, z), x, z0)
    with pltpu.force_tpu_interpret_mode():
        pallas = _chain(lambda xx, z: jiir.iir_biquad_pallas(
            xx, c, z, track_block=tracks), x, z0)
    _assert_pair(ours, xla, SCAN_ATOL)
    _assert_pair(ours, pallas, SCAN_ATOL)


@pytest.mark.parametrize("tracks,s,m", [(8, 128, 16), (8, 128, 128),
                                        (16, 64, 32)])
def test_blockstate_twin_matches_xla_and_pallas(rng, tracks, s, m):
    x = _signal(rng, tracks, s)
    c = _coeffs()
    z0 = (rng.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)
    taps, u = jiir.blockstate_tables(c, m)
    ours = _chain(lambda xx, z: tiir.iir_biquad_blockstate_plain(
        xx, _t(c), _t(taps), _t(u), z), _t(x), _t(z0))
    xla = _chain(lambda xx, z: jiir.iir_biquad_blockstate(
        xx, c, taps, u, z), x, z0)
    with pltpu.force_tpu_interpret_mode():
        pallas = _chain(lambda xx, z: jiir.iir_biquad_blockstate_pallas(
            xx, c, taps, u, z, track_block=tracks), x, z0)
    _assert_pair(ours, xla, BLOCKSTATE_ATOL)
    _assert_pair(ours, pallas, BLOCKSTATE_ATOL)
    # ... and the block-state form is the scan's filter.
    scan = _chain(lambda xx, z: jiir.iir_biquad_xla(xx, c, z), x, z0)
    _assert_pair(ours, scan, BLOCKSTATE_ATOL)


@pytest.mark.parametrize("k,tracks,s", [(10, 8, 32), (1, 8, 16),
                                        (4, 16, 64)])
def test_cascade_twin_matches_systolic_and_chain(rng, k, tracks, s):
    x = _signal(rng, tracks, s)
    c = _coeffs(k)
    z0 = ((rng.random((k, tracks, 2), dtype=np.float32) - 0.5) * 0.2
          ).astype(np.float32)
    ours = _chain(lambda xx, z: tiir.iir_cascade_plain(xx, _t(c), z),
                  _t(x), _t(z0))
    with pltpu.force_tpu_interpret_mode():
        systolic = _chain(lambda xx, z: jiir.iir_cascade_pallas(
            xx, c, z, track_block=tracks), x, z0)
        chain = _chain(lambda xx, z: jiir.iir_cascade_pallas_chain(
            xx, c, z, track_block=tracks), x, z0)
    _assert_pair(ours, systolic, CASCADE_ATOL)
    _assert_pair(ours, chain, CASCADE_ATOL)


@pytest.mark.parametrize("tracks", [13, 5])
def test_cascade_twin_at_unaligned_tracks_is_a_per_stage_composition(
        rng, tracks):
    """At a track count no block divides, the reference's chain wrapper
    pads and calls the systolic kernel (``ops/iir.py:297``); the port's
    twin is held against a per-stage composition of ``iir_biquad_xla``."""
    k, s = 10, 48
    x = _signal(rng, tracks, s)
    c = _coeffs(k)
    z0 = ((rng.random((k, tracks, 2), dtype=np.float32) - 0.5) * 0.2
          ).astype(np.float32)

    def per_stage(xx, zs):
        y, out = xx, []
        for i in range(k):
            y, z = jiir.iir_biquad_xla(y, c[i], zs[i])
            out.append(np.asarray(z))
        return y, np.stack(out)

    ours = _chain(lambda xx, z: tiir.iir_cascade_plain(xx, _t(c), z),
                  _t(x), _t(z0))
    _assert_pair(ours, _chain(per_stage, x, z0), SCAN_ATOL * 10)


@pytest.mark.parametrize("m", [2, 3, 16, 100, 128])
@pytest.mark.parametrize("fc", [0.25, 0.05, 0.45])
def test_blockstate_tables_are_the_reference_tables(m, fc):
    c = biquad_lowpass_coefficients(fc)
    ours = tiir.blockstate_tables(c, m)
    theirs = jiir.blockstate_tables(c, m)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("s,block_m", [(512, 128), (512, 16), (64, 128),
                                       (100, 16), (96, 64), (7, 128),
                                       (509, 128), (2, 2)])
def test_blockstate_effective_m_is_the_reference(s, block_m):
    try:
        want = jiir.blockstate_effective_m(s, block_m)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tiir.blockstate_effective_m(s, block_m)
        assert str(got.value) == str(e)
    else:
        assert tiir.blockstate_effective_m(s, block_m) == want


def _wrapper_cases(rng, tracks=8, s=64):
    x = _t(_signal(rng, tracks, s))
    c1, ck = _t(_coeffs()), _t(_coeffs(10))
    z1 = torch.zeros((tracks, 2))
    zk = torch.full((10, tracks, 2), 0.01)
    taps, u = (_t(a) for a in tiir.blockstate_tables(_coeffs(), 16))
    return {
        "iir_biquad": (lambda: tiir.iir_biquad(x, c1, z1),
                       lambda: tiir.iir_biquad_plain(x, c1, z1)),
        "iir_biquad_blockstate": (
            lambda: tiir.iir_biquad_blockstate(x, c1, taps, u, z1),
            lambda: tiir.iir_biquad_blockstate_plain(x, c1, taps, u, z1)),
        "iir_cascade": (lambda: tiir.iir_cascade(x, ck, zk),
                        lambda: tiir.iir_cascade_plain(x, ck, zk)),
        "iir_cascade_chain": (lambda: tiir.iir_cascade_chain(x, ck, zk),
                              lambda: tiir.iir_cascade_plain(x, ck, zk)),
    }


@pytest.mark.parametrize("kind", sorted(tiir.KERNEL_LAUNCHES))
def test_cpu_wrapper_returns_its_twin_and_launches_nothing(rng, kind):
    wrapper, twin = _wrapper_cases(rng)[kind]
    before = dict(tiir.KERNEL_LAUNCHES)
    got, want = wrapper(), twin()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tiir.KERNEL_LAUNCHES == before


def test_wrappers_reject_what_no_kernel_takes(rng):
    x = _t(_signal(rng, 8, 64))
    c = _t(_coeffs())
    z = torch.zeros((8, 2))
    with pytest.raises(TypeError, match="float32"):
        tiir.iir_biquad(x.double(), c, z)
    with pytest.raises(ValueError, match="contiguous"):
        tiir.iir_biquad(x.t().contiguous().t(), c, z)
    with pytest.raises(ValueError, match="shape"):
        tiir.iir_biquad(x, c, torch.zeros((7, 2)))
    with pytest.raises(ValueError, match="no kernel"):
        tiir.iir_biquad(x.to("meta"), c.to("meta"), z.to("meta"))
    with pytest.raises(ValueError, match="at least one stage"):
        tiir.iir_cascade(x, torch.zeros((0, 5)), torch.zeros((0, 8, 2)))
    taps, u = (_t(a) for a in tiir.blockstate_tables(_coeffs(), 48))
    with pytest.raises(ValueError, match="divide"):
        tiir.iir_biquad_blockstate(x, c, taps, u, z)


def test_wrappers_never_write_their_input_state(rng):
    for wrapper, _ in _wrapper_cases(rng).values():
        y, z_new = wrapper()
        assert z_new.abs().sum() > 0
    z = torch.zeros((8, 2))
    _, z_new = tiir.iir_biquad(_t(_signal(rng, 8, 64)), _t(_coeffs()), z)
    assert z.abs().sum() == 0 and z_new.data_ptr() != z.data_ptr()
