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
  holds the systolic kernel against the chained scans;
* the CUDA blockstate kernel's 3xTF32 arithmetic, emulated here, vs the
  blockstate twin: 1e-6, a tenth of the 1e-5 the card's tests hold the
  kernel to;
* the CUDA systolic cascade kernel's step order on ``cascade_schedule``
  (warm-up, steady and drain quads, the chunk ring with outputs written
  over their inputs), emulated here in float32, vs the cascade twin and
  the Pallas systolic kernel: 1e-5, ``CASCADE_ATOL`` (the emulation rounds
  each product apart, the kernel contracts them into FMAs);
* the CUDA chain cascade kernel's order on ``chain_schedule`` (32-track
  warps, swizzled 32-sample chunk tiles, quads and the staged route's
  tail), emulated the same way, vs the cascade twin and the Pallas chain
  kernel: 1e-5, ``CASCADE_ATOL``.
"""

import pathlib
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
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


def _tf32(v):
    """TF32 of float32 ``v``, rounded to nearest, ties away from zero
    (``cvt.rna.tf32.f32``): add half of the 13 dropped bits, then mask."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _blockstate_3xtf32(x, c, taps, u, state, passes=3):
    """The arithmetic of the CUDA blockstate kernel (``csrc/iir.cu``) on
    the CPU: per 8-sample k-step of each chunk, A_lo B_hi + A_hi B_lo +
    A_hi B_hi (``passes=3``; ``passes=1`` is plain TF32, A_hi B_hi) into a
    fresh float32 sum, added into a float32 running sum across k-steps;
    then the rank-2 state term, y and the carried state as the kernel
    forms them."""
    b0, b1, b2 = c[0], c[1], c[2]
    m = taps.shape[0]
    th, xs_h = _tf32(taps), _tf32(x)
    tl, xs_l = _tf32(taps - th), _tf32(x - xs_h)
    y = torch.empty_like(x)
    z1, z2 = state[:, 0], state[:, 1]
    for n0 in range(0, x.shape[1], m):
        acc = torch.zeros((x.shape[0], m))
        for k0 in range(0, m, 8):
            ch, cl = slice(n0 + k0, n0 + min(k0 + 8, m)), slice(k0, k0 + 8)
            d = xs_h[:, ch] @ th[:, cl].t()
            if passes == 3:
                d = (xs_l[:, ch] @ th[:, cl].t()
                     + xs_h[:, ch] @ tl[:, cl].t()) + d
            acc = acc + d
        w = acc + (z1[:, None] * u[:, 0] + z2[:, None] * u[:, 1])
        wm1 = torch.cat([z1[:, None], w[:, :-1]], dim=1)
        wm2 = torch.cat([z2[:, None], wm1[:, :-1]], dim=1)
        y[:, n0:n0 + m] = b0 * w + b1 * wm1 + b2 * wm2
        z1, z2 = w[:, m - 1], w[:, m - 2]
    return y, torch.stack([z1, z2], dim=1)


@pytest.mark.parametrize("fc", [0.25, 0.05])
def test_blockstate_3xtf32_emulation_is_well_inside_the_bar(rng, fc):
    """At m = 128, over 3 chained blocks of the tests' signals, the CUDA
    kernel's 3xTF32 product (one k-step per tensor-core sum, IEEE sums
    across k-steps) stays within 1e-6 of the float32 twin, a tenth of the
    1e-5 bar; plain TF32 misses that bar."""
    tracks, s, m = 64, 512, 128
    x = _t(_signal(rng, tracks, s))
    c = _t(_coeffs(fc=fc))
    z0 = _t((rng.random((tracks, 2), dtype=np.float32) - 0.5).astype(
        np.float32))
    taps, u = (_t(a) for a in tiir.blockstate_tables(_coeffs(fc=fc), m))
    twin = _chain(lambda xx, z: tiir.iir_biquad_blockstate_plain(
        xx, c, taps, u, z), x, z0)
    split = _chain(lambda xx, z: _blockstate_3xtf32(xx, c, taps, u, z),
                   x, z0)
    plain_tf32 = _chain(lambda xx, z: _blockstate_3xtf32(
        xx, c, taps, u, z, passes=1), x, z0)
    _assert_pair(split, twin, BLOCKSTATE_ATOL / 10)
    assert max(np.abs(a - b).max()
               for a, b in zip(plain_tf32, twin)) > BLOCKSTATE_ATOL


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    v = torch.tensor([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0e-3], dtype=torch.float32)
    got = _tf32(v)
    assert got[:4].tolist() == [one, one + ulp, one + ulp, -(one + ulp)]
    assert got[4].item() == pytest.approx(3.0e-3, rel=2.0 ** -11)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def _stage_samples(sched, k, s):
    """{stage: [samples it updates, in step order]}, and the steps of the
    steady range at which some stage would be dead."""
    seen = {kk: [] for kk in range(k)}
    dead_in_steady = []
    for lo, hi in (sched.warmup, sched.steady, sched.drain):
        for t in range(lo, hi):
            for kk in range(k):
                if 0 <= t - kk < s:
                    seen[kk].append(t - kk)
                elif (lo, hi) == sched.steady:
                    dead_in_steady.append((t, kk))
    return seen, dead_in_steady


@settings(max_examples=150, deadline=None)
@given(k=st.integers(1, 16), s=st.integers(1, 600),
       tracks=st.integers(1, 70000))
def test_cascade_schedule_updates_each_stage_sample_once_in_order(
        k, s, tracks):
    """On ``cascade_schedule``: the blocks cover the tracks with no empty
    block; the three step ranges tile [0, K - 1 + 4 * ceil(S / 4)) in
    whole quads after the K - 1 warm-up steps; every stage updates every
    sample exactly once and in order, and no stage is dead in a steady
    step (the kernel runs those unmasked); every output sample is emitted
    exactly once, by stage K - 1 on that very sample, into the chunk tile
    the ring holds for it; each quad's inputs lie in its own chunk or the
    next."""
    sc = tiir.cascade_schedule(tracks, s, k)
    per_block = 32 * sc.warps
    assert (sc.grid - 1) * per_block < tracks <= sc.grid * per_block
    lag = k - 1
    assert sc.warmup == (0, lag)
    assert sc.warmup[1] == sc.steady[0] and sc.steady[1] == sc.drain[0]
    assert (sc.steady[1] - sc.steady[0]) % 4 == 0
    assert sc.drain[1] == lag + 4 * (-(-s // 4))
    assert sc.drain[1] >= s + k - 1
    seen, dead = _stage_samples(sc, k, s)
    assert dead == []
    assert all(seen[kk] == list(range(s)) for kk in range(k))
    assert (sc.chunks - 1) * 32 < s <= sc.chunks * 32
    emitted = Counter()
    a = lag - lag % 4
    for t in range(sc.steady[0], sc.drain[1]):
        q = (t - lag) // 4
        n = t - lag  # stage K - 1's sample at step t
        assert n // 4 == q and q // 8 < sc.chunks
        emitted[n] += 1
        # the group read at quad q (q + A / 4 + 1) is in chunk q // 8 or
        # the next
        assert (q + a // 4 + 1) // 8 - q // 8 in (0, 1)
    assert all(emitted[n] == 1 for n in range(s))
    assert all(n < -(-s // 4) * 4 for n in emitted)


def _emulate_systolic(x, c, z, sched, ring=3, pitch=36):
    """The CUDA systolic cascade kernel's step order (``csrc/iir.cu``) in
    float32 NumPy, every lane at once: chunks copied into a ring of
    ``ring`` tiles (zeros past S), the warm-up steps from chunk 0, then
    per chunk its steady quads without the mask and its drain quads with
    it, each quad reading the 4-sample group after its carried one and
    writing its 4 outputs over inputs already read, then the chunk stored
    from its tile and the tile given the chunk ``ring`` on."""
    tracks, s = x.shape
    k = c.shape[0]
    lag = k - 1
    d, a = lag % 4, lag - lag % 4
    tiles = np.zeros((ring, tracks, pitch), np.float32)
    y = np.full((tracks, s), np.nan, np.float32)
    z1, z2 = z[:, :, 0].copy(), z[:, :, 1].copy()
    yl = np.zeros((k, tracks), np.float32)

    def load(ch):
        if ch < sched.chunks:
            n0 = 32 * ch
            tiles[ch % ring, :, :32] = 0
            tiles[ch % ring, :, :min(32, s - n0)] = x[:, n0:n0 + 32]

    def step(xin, t, masked):
        for kk in range(k - 1, -1, -1):
            v = xin if kk == 0 else yl[kk - 1]
            b0, b1, b2, a1, a2 = c[kk]
            w = v - a1 * z1[kk] - a2 * z2[kk]
            out = b0 * w + b1 * z1[kk] + b2 * z2[kk]
            if not masked or 0 <= t - kk < s:
                z2[kk], z1[kk] = z1[kk], w
            else:
                assert masked
            yl[kk] = out

    for ch in range(ring):
        load(ch)
    for j in range(a // 4 + 1):
        win = tiles[0, :, 4 * j:4 * j + 4].copy()
        for i in range(4):
            if 4 * j + i < lag:
                step(win[:, i], 4 * j + i, True)
    steady_quads = (sched.steady[1] - lag) // 4
    quads = (sched.drain[1] - lag) // 4
    for o in range(sched.chunks):
        cur, nxt = tiles[o % ring], tiles[(o + 1) % ring]
        g0 = 8 * o
        g1 = min(g0 + 8, quads)
        gs = min(max(g0, steady_quads), g1)
        for g in range(g0, g1):
            masked = g >= gs
            j = g - g0 + a // 4 + 1
            nx = (cur[:, 4 * j:4 * j + 4] if j < 8
                  else nxt[:, 4 * (j - 8):4 * (j - 8) + 4]).copy()
            t0 = 4 * g + lag
            outs = []
            for i in range(4):
                xin = win[:, i + d] if i + d < 4 else nx[:, i + d - 4]
                if masked and t0 + i >= s:
                    xin = np.zeros_like(xin)
                step(xin, t0 + i, masked)
                outs.append(yl[k - 1].copy())
            win = nx
            cur[:, 4 * (g - g0):4 * (g - g0) + 4] = np.stack(outs, axis=1)
        n0 = 32 * o
        y[:, n0:n0 + 32] = cur[:, :min(32, s - n0)]
        load(o + ring)
    return y, np.stack([z1, z2], axis=2)


@pytest.mark.parametrize("k,tracks,s,vs_pallas", [
    (10, 8, 32, True), (1, 8, 16, True), (16, 5, 96, True),
    (10, 3, 4, True), (2, 7, 7, False), (16, 3, 1, False),
    (3, 9, 70, False), (4, 6, 130, False), (13, 2, 33, False)])
def test_cascade_kernel_step_order_matches_twin_and_pallas(
        rng, k, tracks, s, vs_pallas):
    """The emulated kernel, states chained over 3 blocks on the schedule
    of each shape (S < K - 1, S not a multiple of 4, a ragged last chunk,
    several chunks), against the twin and, where marked, the JAX
    systolic kernel in interpret mode."""
    x = _signal(rng, tracks, s)
    c = _coeffs(k)
    z0 = ((rng.random((k, tracks, 2), dtype=np.float32) - 0.5) * 0.2
          ).astype(np.float32)
    sched = tiir.cascade_schedule(tracks, s, k)
    emu = _chain(lambda xx, z: _emulate_systolic(xx, c, z, sched), x, z0)
    assert np.isfinite(emu[0]).all() and np.isfinite(emu[1]).all()
    twin = _chain(lambda xx, z: tiir.iir_cascade_plain(xx, _t(c), z),
                  _t(x), _t(z0))
    _assert_pair(emu, twin, CASCADE_ATOL)
    if vs_pallas:
        with pltpu.force_tpu_interpret_mode():
            systolic = _chain(lambda xx, z: jiir.iir_cascade_pallas(
                xx, c, z, track_block=tracks), x, z0)
        _assert_pair(emu, systolic, CASCADE_ATOL)


def test_cascade_schedule_at_the_main_shape():
    """65,536 tracks x 512, K = 10: 512 blocks of 4 warps (2,048 warps,
    one wave at 16 warps an SM), 125 steady quads, 12 drain steps, 16
    chunks; and a bad shape is refused."""
    sc = tiir.cascade_schedule(65536, 512, 10)
    assert (sc.grid, sc.warps, sc.chunks) == (512, 4, 16)
    assert sc.warmup == (0, 9) and sc.steady == (9, 509)
    assert sc.drain == (509, 521)
    with pytest.raises(ValueError):
        tiir.cascade_schedule(0, 512, 10)


# -- the chain cascade kernel's host side and tile layout ----------------
#
# ``chain_schedule`` picks the route before the launch: TMA where the rows
# are a multiple of 16 bytes (S % 4 == 0) and x is 16-byte aligned, else
# the staged route. The tile layout is the TMA's 128-byte swizzle.

@pytest.mark.parametrize("s,x_ptr,route", [
    (512, 0, "tma"), (4, 0x1000, "tma"), (96, 16, "tma"),
    (521, 0, "staged"), (7, 0, "staged"), (1, 0, "staged"),
    (30, 0, "staged"), (512, 4, "staged"), (512, 8, "staged"),
    (512, 0x1004, "staged")])
def test_chain_schedule_route_rule(s, x_ptr, route):
    assert tiir.chain_schedule(1000, s, x_ptr).route == route
    assert route in tiir.CHAIN_ROUTES


@pytest.mark.parametrize("tracks,s", [(1, 1), (33, 4), (128, 32), (129, 33),
                                      (1000, 96), (1001, 521), (65536, 512),
                                      (70000, 600)])
def test_chain_schedule_grid_and_tensor_map(tracks, s):
    """Blocks of 4 warps, a warp 32 tracks: the grid covers the tracks
    with no empty block; the chunks cover S; the tensor map is (S,
    tracks) innermost first, rows 4S bytes apart (a multiple of 16 on the
    TMA route, as cuTensorMapEncodeTiled needs), boxes of 32 samples x 32
    tracks whose 128-byte rows are the swizzle's span (a box dimension
    may be at most 256)."""
    sc = tiir.chain_schedule(tracks, s)
    per_block = 32 * sc.warps
    assert sc.warps == tiir.CHAIN_WARPS == 4
    assert (sc.grid - 1) * per_block < tracks <= sc.grid * per_block
    assert (sc.chunks - 1) * sc.box[0] < s <= sc.chunks * sc.box[0]
    assert sc.global_dims == (s, tracks)
    assert sc.row_pitch == 4 * s
    assert (sc.route == "tma") == (sc.row_pitch % 16 == 0)
    assert sc.box == (32, 32) and all(1 <= b <= 256 for b in sc.box)
    assert 4 * sc.box[0] == sc.swizzle == 128
    with pytest.raises(ValueError):
        tiir.chain_schedule(0, s)


def test_chain_schedule_at_the_main_shape():
    """65,536 x 512: 512 blocks of 4 warps (2,048 warps, one wave at 4
    blocks an SM on 132 SMs), 16 chunks, the TMA route."""
    sc = tiir.chain_schedule(65536, 512)
    assert (sc.route, sc.grid, sc.warps, sc.chunks) == ("tma", 512, 4, 16)
    assert sc.grid <= 4 * 132


# ``csrc/iir.cu`` ch_swizzle: the offset (floats) of sample j of row r in a
# chain tile; the 16-byte piece j / 4 of a row sits at piece (j / 4) ^
# (r % 8). The test below holds this copy to the source.
CH_SWIZZLE = "32 * r + ((((j >> 2) ^ r) & 7) << 2) + (j & 3)"


def _tile_offset(r, j):
    return 32 * r + ((((j >> 2) ^ r) & 7) << 2) + (j & 3)


def test_chain_tile_offset_is_the_kernels():
    src = (pathlib.Path(tiir.__file__).parents[1] / "csrc" / "iir.cu").read_text()
    assert f"return {CH_SWIZZLE};" in src
    r, j = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    np.testing.assert_array_equal(eval(CH_SWIZZLE), _tile_offset(r, j))


def _tma_swizzle_128(byte_offset):
    """The 128-byte swizzle's address map: bits [4:6] of a byte offset
    XOR bits [7:9]."""
    return byte_offset ^ (((byte_offset >> 7) & 7) << 4)


def test_chain_tile_offsets_are_the_tma_swizzle_and_a_bijection():
    rows, samples = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    off = _tile_offset(rows, samples)
    assert sorted(off.ravel()) == list(range(32 * 32))  # one slot each
    dense = 4 * (32 * rows + samples)
    np.testing.assert_array_equal(4 * off, _tma_swizzle_128(dense))


@pytest.mark.parametrize("quad", range(8))
def test_chain_tile_quad_reads_are_free_of_bank_conflicts(quad):
    """Lane r reads samples 4q .. 4q + 3 of row r (16 bytes); a warp's
    16-byte accesses go by quarter-warps, and each quarter-warp's 8 reads
    fall in 8 distinct 16-byte pieces of the 128-byte bank line."""
    lanes = np.arange(32)
    off = _tile_offset(lanes, np.full(32, 4 * quad))
    assert (off % 4 == 0).all()  # 16-byte aligned
    for g in range(4):
        pieces = (off[8 * g:8 * g + 8] // 4) % 8
        assert len(set(pieces)) == 8


def test_chain_tile_staged_copies_are_free_of_bank_conflicts():
    """The staged route's fill and store: lane j moves sample j of one row
    at a time (32 banks once), and the tail's scalar reads (lane r,
    sample j of row r) fall on 8 banks, 4 lanes a bank."""
    lanes = np.arange(32)
    for r in range(32):
        banks = _tile_offset(np.full(32, r), lanes) % 32
        assert len(set(banks)) == 32
    for j in range(32):
        banks = _tile_offset(lanes, np.full(32, j)) % 32
        assert len(set(banks)) == 8


def _emulate_chain(x, c, z, sched):
    """The CUDA chain cascade kernel's order (``csrc/iir.cu``) in float32
    NumPy, every warp and lane at once: per 32-sample chunk each warp's
    tile filled through the swizzled offsets (zeros past S and past the
    last track), each lane walking its row a quad at a time, every sample
    through the K stages in order before the next, outputs written over
    their inputs, the chunk's last S % 4 samples one at a time on the
    staged route, then the tile stored back through the same offsets."""
    tracks, s = x.shape
    k = c.shape[0]
    rows_all = 32 * sched.warps * sched.grid
    xp = np.zeros((rows_all, s), np.float32)
    xp[:tracks] = x
    y = np.full((rows_all, s), np.nan, np.float32)
    z1 = np.zeros((k, rows_all), np.float32)
    z2 = np.zeros((k, rows_all), np.float32)
    z1[:, :tracks], z2[:, :tracks] = z[:, :, 0], z[:, :, 1]
    warps = rows_all // 32
    r = np.arange(32)

    def stage_samples(v):
        for kk in range(k):
            b0, b1, b2, a1, a2 = c[kk]
            w = v - a1 * z1[kk] - a2 * z2[kk]
            v = b0 * w + b1 * z1[kk] + b2 * z2[kk]
            z2[kk], z1[kk] = z1[kk].copy(), w
        return v

    for ch in range(sched.chunks):
        n0 = 32 * ch
        ln = min(32, s - n0)
        tiles = np.zeros((warps, 32 * 32), np.float32)
        for j in range(ln):
            tiles[:, _tile_offset(r, j)] = xp[:, n0 + j].reshape(warps, 32)
        lanes_off = lambda j: _tile_offset(r, j)  # noqa: E731
        quads = ln // 4
        for q in range(quads):
            for j in range(4 * q, 4 * q + 4):
                v = tiles[:, lanes_off(j)].reshape(-1)
                tiles[:, lanes_off(j)] = stage_samples(v).reshape(warps, 32)
        assert sched.route == "staged" or ln % 4 == 0
        for j in range(4 * quads, ln):
            v = tiles[:, lanes_off(j)].reshape(-1)
            tiles[:, lanes_off(j)] = stage_samples(v).reshape(warps, 32)
        for j in range(ln):
            y[:, n0 + j] = tiles[:, _tile_offset(r, j)].reshape(-1)
    return y[:tracks], np.stack([z1[:, :tracks], z2[:, :tracks]], axis=2)


@pytest.mark.parametrize("k,tracks,s,vs_pallas", [
    (10, 8, 32, True), (1, 8, 16, True), (16, 5, 96, True),
    (10, 3, 4, True), (2, 7, 7, False), (16, 3, 1, False),
    (3, 130, 70, False), (4, 6, 130, False), (13, 33, 33, False)])
def test_chain_kernel_order_matches_twin_and_pallas(rng, k, tracks, s,
                                                    vs_pallas):
    """The emulated chain kernel, states chained over 3 blocks on the
    schedule of each shape (both routes, a ragged last chunk and block,
    S < 4), against the twin and, where marked, the JAX chain kernel in
    interpret mode."""
    x = _signal(rng, tracks, s)
    c = _coeffs(k)
    z0 = ((rng.random((k, tracks, 2), dtype=np.float32) - 0.5) * 0.2
          ).astype(np.float32)
    sched = tiir.chain_schedule(tracks, s)
    emu = _chain(lambda xx, z: _emulate_chain(xx, c, z, sched), x, z0)
    assert np.isfinite(emu[0]).all() and np.isfinite(emu[1]).all()
    twin = _chain(lambda xx, z: tiir.iir_cascade_plain(xx, _t(c), z),
                  _t(x), _t(z0))
    _assert_pair(emu, twin, CASCADE_ATOL)
    if vs_pallas:
        with pltpu.force_tpu_interpret_mode():
            chain = _chain(lambda xx, z: jiir.iir_cascade_pallas_chain(
                xx, c, z, track_block=tracks), x, z0)
        _assert_pair(emu, chain, CASCADE_ATOL)
