"""The hand-written CUDA kernels (the modal bank in its rotation and
resonator forms, the four IIR kernels, the Conv1D FIR, the RndMem gather,
the DWG block, the two FDTD forms, the divergence form on both routes,
and the two speed-of-light FMA kernels)
against their plain PyTorch twins, on the GPU, with the SOL GEMMs against
their goldens and the device tier against the profiler; and NeuralAmp's
blocks, the LSTM's graph replay against its eager block and both
architectures against the CPU twin. Marked ``cuda``: each test skips where
there is no CUDA device.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Modal tolerance: outputs max|kernel - plain| <= 1e-5 * max|plain| (the
kernel sums modes in another order and contracts the rotation into
FMAs); states 1e-5 absolute. The resonator kernel rounds like its twin
mode by mode, so the same bars hold, and 1e-5 of the peak against
``modal_reference_gs`` (the reference's bar, tests/test_pallas_ops.py:432).
The tolerances of the other kernels are stated at their tests below.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu_torch.models.conv1d import conv1d_reference
from gpuaudiobench_tpu_torch.models.dwg import dwg_reference
from gpuaudiobench_tpu_torch.ops import dwg as dops
from gpuaudiobench_tpu_torch.ops import gpuab
from gpuaudiobench_tpu_torch.ops import fdtd3d as fops
from gpuaudiobench_tpu_torch.ops import rndmem as rops
from gpuaudiobench_tpu_torch.models.modal import modal_reference_gs
from gpuaudiobench_tpu_torch.ops import conv as cops
from gpuaudiobench_tpu_torch.ops import iir as iops
from gpuaudiobench_tpu_torch.ops import modal as tops
from gpuaudiobench_tpu_torch.ops import speedoflight as sops
from gpuaudiobench_tpu_torch.utils.data import (
    biquad_lowpass_coefficients,
    conv1d_impulse_responses,
)

pytestmark = pytest.mark.cuda
OUT_RTOL = 1e-5
STATE_ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _tables(m, device, seed=7):
    g = np.random.Generator(np.random.MT19937(seed))
    amp = g.random(m, dtype=np.float32)
    w = (2 * np.pi * g.random(m, dtype=np.float32) * 0.45).astype(np.float32)
    tabs = [amp, np.cos(w).astype(np.float32), np.sin(w).astype(np.float32),
            (g.random(m, dtype=np.float32) * 2 - 1).astype(np.float32),
            (g.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)]
    return [torch.from_numpy(a).to(device) for a in tabs]


def _close(got, want):
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= OUT_RTOL * want.abs().max().item(), err


MODAL_SHAPES = [
    (4096, 32, 32), (960, 64, 32), (256, 32, 8), (33024, 40, 16), (64, 7, 1),
    (3000, 64, 12), (999, 32, 3), (192, 16, 64),
]


@pytest.mark.parametrize("m,s,t_out", MODAL_SHAPES)
def test_kernel_matches_plain_twin(cuda, m, s, t_out):
    amp, cw, sw, re, im = _tables(m, cuda)
    launches = tops.KERNEL_LAUNCHES["modal_bank"]
    out, re_o, im_o = tops.modal_bank(amp, cw, sw, re, im, s, t_out)
    assert re_o is re and im_o is im
    plain, _, _ = tops.modal_bank_plain(amp, cw, sw, re, im, s, t_out)
    _close(out, plain)

    kre, kim = amp * re, amp * im
    pre, pim = kre, kim
    for _ in range(2):
        kout, kre, kim = tops.modal_folded_step(cw, sw, kre, kim, s, t_out)
        pout, pre, pim = tops.modal_folded_step_plain(cw, sw, pre, pim, s, t_out)
        _close(kout, pout)
    torch.cuda.synchronize()
    assert (kre - pre).abs().max().item() <= STATE_ATOL
    assert (kim - pim).abs().max().item() <= STATE_ATOL
    assert tops.KERNEL_LAUNCHES["modal_bank"] == launches + 3


def test_kernel_is_deterministic(cuda):
    amp, cw, sw, re, im = _tables(70016, cuda)
    a = tops.modal_folded_step(cw, sw, amp * re, amp * im, 64, 32)
    b = tops.modal_folded_step(cw, sw, amp * re, amp * im, 64, 32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("t_out", [3, 12, 64])
def test_kernel_rejects_tracks_not_dividing_32(cuda, t_out):
    """The fault this test once pinned is repaired: both kernels take any
    T_out that divides M, deterministically, and refuse one that does
    not."""
    amp, cw, sw, re, im = _tables(192 * 5, cuda)
    for algorithm in ("rotation", "res"):
        a, _, _ = tops.modal_bank(amp, cw, sw, re, im, 16, t_out,
                                  algorithm=algorithm)
        b, _, _ = tops.modal_bank(amp, cw, sw, re, im, 16, t_out,
                                  algorithm=algorithm)
        assert torch.equal(a, b)
        plain, _, _ = tops.modal_bank_plain(amp, cw, sw, re, im, 16, t_out,
                                            algorithm=algorithm)
        _close(a, plain)
    with pytest.raises(ValueError, match="multiple of output_tracks"):
        tops.modal_bank(*_tables(100, cuda), 16, t_out)


@pytest.mark.parametrize("m,s,t_out", MODAL_SHAPES)
def test_res_kernel_matches_plain_twin(cuda, m, s, t_out):
    amp, cw, sw, re, im = _tables(m, cuda)
    launches = tops.KERNEL_LAUNCHES["modal_res"]
    out, re_o, im_o = tops.modal_bank(amp, cw, sw, re, im, s, t_out,
                                      algorithm="res")
    assert re_o is re and im_o is im
    plain, _, _ = tops.modal_bank_plain(amp, cw, sw, re, im, s, t_out,
                                        algorithm="res")
    _close(out, plain)
    eps, ky, kq = tops.res_init(cw, sw, amp * re, amp * im)
    py, pq = ky, kq
    for _ in range(2):
        kout, ky, kq = tops.modal_res_step(eps, ky, kq, s, t_out)
        pout, py, pq = tops.modal_res_step_plain(eps, py, pq, s, t_out)
        _close(kout, pout)
    torch.cuda.synchronize()
    assert (ky - py).abs().max().item() <= STATE_ATOL
    assert (kq - pq).abs().max().item() <= STATE_ATOL
    assert tops.KERNEL_LAUNCHES["modal_res"] == launches + 3


@pytest.mark.parametrize("m,s,t_out", [(1024, 64, 32), (3000, 64, 12)])
def test_res_kernel_matches_gs_golden(cuda, m, s, t_out):
    tabs = _tables(m, cuda, seed=3)
    out, _, _ = tops.modal_bank(*tabs, s, t_out, algorithm="res")
    ref = modal_reference_gs(*(t.cpu().numpy() for t in tabs), s, t_out)
    err = np.abs(out.cpu().numpy().astype(np.float64) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_res_kernel_is_deterministic(cuda):
    amp, cw, sw, re, im = _tables(70016, cuda)
    eps, y, q = tops.res_init(cw, sw, amp * re, amp * im)
    a = tops.modal_res_step(eps, y, q, 64, 32)
    b = tops.modal_res_step(eps, y, q, 64, 32)
    for x, z in zip(a, b):
        assert torch.equal(x, z)


# The persistent grid's edges: a ragged M whose tiles do not divide among
# the blocks, T_out 3, 8, 12 and 32, fewer tiles than SMs (one warp's
# tile a block), and more tiles than the grid takes in one pass.
SCHEDULE_SHAPES = [
    (70048, 64, 32), (12288, 128, 12), (999, 32, 3), (33024, 40, 8),
    (96, 16, 3), (4194304, 16, 32),
]


@pytest.mark.parametrize("m,s,t_out", SCHEDULE_SHAPES)
def test_kernel_on_the_schedule_edges(cuda, m, s, t_out):
    """Both forms under both contracts against their twins, and bit for
    bit from run to run, at the persistent grid's edges."""
    amp, cw, sw, re, im = _tables(m, cuda, seed=m % 97)
    sched = tops._schedule(tops._lib(), "rotation", m, t_out, cuda)
    if m == 4194304:
        assert sched.passes > 1
    if m == 96:
        assert sched.grid < torch.cuda.get_device_properties(0).multi_processor_count
    runs = []
    for _ in range(2):
        out, _, _ = tops.modal_bank(amp, cw, sw, re, im, s, t_out)
        step = tops.modal_folded_step(cw, sw, amp * re, amp * im, s, t_out)
        eps, y, q = tops.res_init(cw, sw, amp * re, amp * im)
        res = tops.modal_res_step(eps, y, q, s, t_out)
        runs.append((out, *step, *res))
    for x, z in zip(*runs):
        assert torch.equal(x, z)
    out, step_out, kre, kim, res_out, ky, kq = runs[0]
    plain, _, _ = tops.modal_bank_plain(amp, cw, sw, re, im, s, t_out)
    _close(out, plain)
    pout, pre, pim = tops.modal_folded_step_plain(cw, sw, amp * re, amp * im,
                                                  s, t_out)
    _close(step_out, pout)
    assert (kre - pre).abs().max().item() <= STATE_ATOL
    assert (kim - pim).abs().max().item() <= STATE_ATOL
    rout, py, pq = tops.modal_res_step_plain(eps, y, q, s, t_out)
    _close(res_out, rout)
    assert (ky - py).abs().max().item() <= STATE_ATOL
    assert (kq - pq).abs().max().item() <= STATE_ATOL


# -- the four IIR kernels (csrc/iir.cu) against their plain twins --------
#
# Tolerance: 1e-5 absolute on outputs and states, kernel vs twin. The
# kernels contract the recurrence into FMAs, and the blockstate kernel
# forms its chunk product in 3xTF32 on the tensor cores, one 8-sample
# k-step per tensor-core sum and FP32 sums across k-steps (~3e-7 on these
# unit-scale signals; tests/test_torch_iir_ops.py emulates it on the
# CPU); 1e-5 is the reference's own bar for the blockstate form against
# the scan (tests/test_pallas_ops.py:526).
# Systolic vs chain cascade: 1e-6 absolute and relative, the reference's
# cross-check (tests/test_pallas_ops.py:165-191).

IIR_ATOL = 1e-5
CASCADE_TOL = 1e-6
# (1000, 96): a track count no warp's 8-track group divides, and S = 96,
# where block_m 12 gives m = 12 (not a multiple of 8) and 128 gives m = 96.
IIR_SHAPES = [(8, 64), (640, 128), (65536, 512), (1000, 96)]
N_STAGES = 10


def _iir_inputs(tracks, s, device, k=None, seed=11):
    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    if k is None:
        c = np.array(biquad_lowpass_coefficients(0.25), np.float32)
        z = (g.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)
    else:
        c = np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * i)
                      for i in range(k)], np.float32)
        z = ((g.random((k, tracks, 2), dtype=np.float32) - 0.5)
             * 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, c, z)]


def _blockstate_tables(c, s, block_m, device):
    m = iops.blockstate_effective_m(s, block_m)
    taps, u = iops.blockstate_tables(c.cpu().numpy(), m)
    return torch.from_numpy(taps).to(device), torch.from_numpy(u).to(device)


def _iir_pair(kind, tracks, s, device, block_m=128):
    """(kernel, twin, inputs) for one of the four wrappers; each callable
    takes (x, state) and returns (y, state')."""
    k = N_STAGES if kind.startswith("iir_cascade") else None
    x, c, z = _iir_inputs(tracks, s, device, k=k)
    if kind == "iir_biquad":
        return (lambda xx, zz: iops.iir_biquad(xx, c, zz),
                lambda xx, zz: iops.iir_biquad_plain(xx, c, zz), x, z)
    if kind == "iir_biquad_blockstate":
        taps, u = _blockstate_tables(c, s, block_m, device)
        return (lambda xx, zz: iops.iir_biquad_blockstate(xx, c, taps, u, zz),
                lambda xx, zz: iops.iir_biquad_blockstate_plain(
                    xx, c, taps, u, zz), x, z)
    fn = getattr(iops, kind)
    return (lambda xx, zz: fn(xx, c, zz),
            lambda xx, zz: iops.iir_cascade_plain(xx, c, zz), x, z)


IIR_CASES = [("iir_biquad", 128), ("iir_biquad_blockstate", 12),
             ("iir_biquad_blockstate", 16), ("iir_biquad_blockstate", 128),
             ("iir_cascade", 128), ("iir_cascade_chain", 128)]


@pytest.mark.parametrize("tracks,s", IIR_SHAPES)
@pytest.mark.parametrize("kind,block_m", IIR_CASES)
def test_iir_kernel_matches_plain_twin(cuda, kind, block_m, tracks, s):
    assert not torch.backends.cuda.matmul.allow_tf32
    kern, plain, x, z0 = _iir_pair(kind, tracks, s, cuda, block_m)
    z0_copy = z0.clone()
    launches = iops.KERNEL_LAUNCHES[kind]
    zk, zp = z0, z0
    for _ in range(3):  # states chained over 3 blocks
        yk, zk = kern(x, zk)
        yp, zp = plain(x, zp)
        assert yk.shape == yp.shape and zk.shape == zp.shape
        assert (yk - yp).abs().max().item() <= IIR_ATOL
        assert (zk - zp).abs().max().item() <= IIR_ATOL
    torch.cuda.synchronize()
    assert iops.KERNEL_LAUNCHES[kind] == launches + 3
    assert torch.equal(z0, z0_copy)  # the input state is never written


@pytest.mark.parametrize("kind,block_m", IIR_CASES)
def test_iir_kernel_is_deterministic(cuda, kind, block_m):
    kern, _, x, z = _iir_pair(kind, 4096, 512, cuda, block_m)
    z_copy = z.clone()
    y1, z1 = kern(x, z)
    y2, z2 = kern(x, z)
    assert torch.equal(y1, y2) and torch.equal(z1, z2)
    assert torch.equal(z, z_copy)


# (tracks, S, block_m): m the blockstate kernel pads to 16, 32, 64 or 128
# (2, 3, 7, 12, 102, 124, 127, 128), with 16-byte and 4-byte copies, at
# track counts no 8-track group divides.
BLOCKSTATE_M_CASES = [(8, 64, 2), (17, 30, 3), (33, 14, 7), (1000, 96, 12),
                      (3, 510, 102), (100, 248, 124), (5, 381, 127),
                      (1000, 512, 128)]


@pytest.mark.parametrize("tracks,s,block_m", BLOCKSTATE_M_CASES)
def test_iir_blockstate_every_m_matches_twin_and_is_deterministic(
        cuda, tracks, s, block_m):
    kern, plain, x, z0 = _iir_pair("iir_biquad_blockstate", tracks, s, cuda,
                                   block_m)
    zk, zp = z0, z0
    for _ in range(3):
        yk, zk = kern(x, zk)
        yp, zp = plain(x, zp)
        assert (yk - yp).abs().max().item() <= IIR_ATOL
        assert (zk - zp).abs().max().item() <= IIR_ATOL
    y1, z1 = kern(x, z0)
    y2, z2 = kern(x, z0)
    assert torch.equal(y1, y2) and torch.equal(z1, z2)


# (K, tracks, S) at the systolic kernel's schedule edges: K = 1 (no lag),
# 2 and 16 (the deepest instance), S = 1, 4 and 7 (no steady step when
# S < K - 1, S not a multiple of 4: the 4-byte copies) and 521 (a ragged
# last chunk), odd and ragged track counts (a partial warp, a partial
# block).
CASCADE_EDGES = [(k, tracks, s) for k in (1, 2, 16)
                 for tracks, s in ((33, 1), (1000, 4), (77, 7), (1001, 521))]


@pytest.mark.parametrize("k,tracks,s", [(N_STAGES, 640, 128),
                                        (N_STAGES, 65536, 512),
                                        (N_STAGES, 33, 7)] + CASCADE_EDGES)
def test_iir_cascade_systolic_matches_chain(cuda, k, tracks, s):
    x, c, z = _iir_inputs(tracks, s, cuda, k=k)
    zs, zc = z, z
    for _ in range(3):
        ys, zs = iops.iir_cascade(x, c, zs)
        yc, zc = iops.iir_cascade_chain(x, c, zc)
        torch.testing.assert_close(ys, yc, atol=CASCADE_TOL, rtol=CASCADE_TOL)
        torch.testing.assert_close(zs, zc, atol=CASCADE_TOL, rtol=CASCADE_TOL)


@pytest.mark.parametrize("k,tracks,s", CASCADE_EDGES)
@pytest.mark.parametrize("kind", ["iir_cascade", "iir_cascade_chain"])
def test_iir_cascade_edges_match_twin_and_are_deterministic(
        cuda, kind, k, tracks, s):
    x, c, z0 = _iir_inputs(tracks, s, cuda, k=k)
    z_copy = z0.clone()
    kern = getattr(iops, kind)
    launches = iops.KERNEL_LAUNCHES[kind]
    zk, zp = z0, z0
    for _ in range(3):  # states chained over 3 blocks
        yk, zk = kern(x, c, zk)
        yp, zp = iops.iir_cascade_plain(x, c, zp)
        assert (yk - yp).abs().max().item() <= IIR_ATOL
        assert (zk - zp).abs().max().item() <= IIR_ATOL
    y1, z1 = kern(x, c, z0)
    y2, z2 = kern(x, c, z0)
    assert torch.equal(y1, y2) and torch.equal(z1, z2)
    torch.cuda.synchronize()
    assert iops.KERNEL_LAUNCHES[kind] == launches + 5
    assert torch.equal(z0, z_copy)


# The chain cascade's two routes (ops/iir.py chain_schedule): TMA where
# S % 4 == 0 and x is 16-byte aligned, else staged (an unaligned copy of
# x takes it at any S). Both routes give the same bits; each holds to the
# twin (IIR_ATOL) and to the systolic kernel (CASCADE_TOL).
CHAIN_ROUTE_CASES = [(10, 65536, 512), (10, 1000, 96), (16, 1001, 521),
                     (1, 33, 4), (2, 77, 7), (16, 129, 30), (10, 5, 1)]


def _unaligned(x):
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    u = buf[1:].view(x.shape)
    u.copy_(x)
    return u


@pytest.mark.parametrize("k,tracks,s", CHAIN_ROUTE_CASES)
def test_iir_cascade_chain_routes_match_twin_systolic_and_each_other(
        cuda, k, tracks, s):
    x, c, z0 = _iir_inputs(tracks, s, cuda, k=k)
    xu = _unaligned(x)
    rule = iops.chain_schedule(tracks, s, x.data_ptr()).route
    assert rule == ("tma" if s % 4 == 0 else "staged")
    routes = dict(iops.CHAIN_ROUTE_LAUNCHES)
    zc, zs, zp = z0, z0, z0
    for _ in range(3):  # states chained over 3 blocks
        yc, zc_next = iops.iir_cascade_chain(x, c, zc)
        yu, zu = iops.iir_cascade_chain(xu, c, zc)  # the staged route
        assert torch.equal(yu, yc) and torch.equal(zu, zc_next)
        zc = zc_next
        ys, zs = iops.iir_cascade(x, c, zs)
        yp, zp = iops.iir_cascade_plain(x, c, zp)
        assert (yc - yp).abs().max().item() <= IIR_ATOL
        assert (zc - zp).abs().max().item() <= IIR_ATOL
        torch.testing.assert_close(ys, yc, atol=CASCADE_TOL, rtol=CASCADE_TOL)
        torch.testing.assert_close(zs, zc, atol=CASCADE_TOL, rtol=CASCADE_TOL)
    torch.cuda.synchronize()
    got = {r: n - routes[r] for r, n in iops.CHAIN_ROUTE_LAUNCHES.items()}
    assert got == ({"tma": 3, "staged": 3} if rule == "tma"
                   else {"tma": 0, "staged": 6})


@pytest.mark.parametrize("s,offset", [(30, 0), (32, 1)])
def test_iir_cascade_chain_entry_refuses_a_tma_route_it_cannot_take(
        cuda, s, offset):
    """The C entry refuses the TMA route (0) for S % 4 != 0 or an
    unaligned x, launching nothing, and takes the staged route (1) there:
    a route, never a fallback."""
    x, c, z = _iir_inputs(64, s, cuda, k=3)
    if offset:
        x = _unaligned(x)
    sc = iops.chain_schedule(64, s, x.data_ptr())
    assert sc.route == "staged"
    ops = gpuab.load()
    with pytest.raises(RuntimeError, match="iir_cascade_chain_launch failed"):
        ops.iir_cascade_chain_launch(x, c, z, 0, sc.grid, sc.chunks)
    y, zo = ops.iir_cascade_chain_launch(x, c, z, 1, sc.grid, sc.chunks)
    # Route -1 (a traced program's) takes the rule on this pointer.
    y_rule, z_rule = ops.iir_cascade_chain_launch(x, c, z, -1, sc.grid,
                                                  sc.chunks)
    assert torch.equal(y_rule, y) and torch.equal(z_rule, zo)
    yp, zp = iops.iir_cascade_plain(x, c, z)
    assert (y - yp).abs().max().item() <= IIR_ATOL
    assert (zo - zp).abs().max().item() <= IIR_ATOL


@pytest.mark.parametrize("kind,block_m", IIR_CASES)
def test_iir_wrapper_rejects_bad_input(cuda, kind, block_m):
    kern, _, x, z = _iir_pair(kind, 64, 128, cuda, block_m)
    with pytest.raises(TypeError, match="float32"):
        kern(x.double(), z)
    with pytest.raises(ValueError, match="contiguous"):
        kern(x.t().contiguous().t(), z)
    with pytest.raises(ValueError, match="on cpu"):
        kern(x, z.cpu())


def test_iir_blockstate_rejects_m_not_dividing_s(cuda):
    x, c, z = _iir_inputs(8, 96, cuda)
    taps, u = iops.blockstate_tables(c.cpu().numpy(), 64)
    with pytest.raises(ValueError, match="divide"):
        iops.iir_biquad_blockstate(x, c, torch.from_numpy(taps).to(cuda),
                                   torch.from_numpy(u).to(cuda), z)


# -- the Conv1D FIR kernel (csrc/conv1d.cu) against its plain twin ------
#
# Tolerance: 1e-5 absolute, kernel vs twin, in both edge modes, on
# N(0, 0.1^2) IRs whose outputs are of unit scale. The kernel contracts
# each tap's multiply-add into an FMA; the sums run in the same tap order
# (~1e-7 on these signals). The benchmark's own IR bank (windowed sinc
# over L) gives outputs near 1e-3 rms, so there the bar is 1e-5 of the
# twin's peak.

CONV_ATOL = 1e-5
CONV_BANK_RTOL = 1e-5
CONV_SHAPES = [(130, 48, 16), (8, 64, 7), (6, 16, 40), (4, 32, 8),
               (3, 1100, 1500), (128, 512, 1024), (19456, 512, 1024)]


def _conv_inputs(tracks, s, l, device, bank=False, seed=5):
    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    if bank:
        ir = conv1d_impulse_responses(tracks, l)
    else:
        ir = (g.standard_normal((tracks, l), dtype=np.float32)
              * 0.1).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(ir).to(device)


@pytest.mark.parametrize("bank", [False, True])
@pytest.mark.parametrize("mode", ["clamp", "bleed"])
@pytest.mark.parametrize("tracks,s,l", CONV_SHAPES)
def test_conv_kernel_matches_plain_twin(cuda, tracks, s, l, mode, bank):
    x, ir = _conv_inputs(tracks, s, l, cuda, bank=bank)
    launches = cops.KERNEL_LAUNCHES["conv1d"]
    got = cops.conv1d_direct(x, ir, mode)
    want = cops.conv1d_direct_plain(x, ir, mode)
    torch.cuda.synchronize()
    assert got.shape == (tracks, s)
    err = (got - want).abs().max().item()
    assert err <= (CONV_BANK_RTOL * want.abs().max().item() if bank
                   else CONV_ATOL), err
    assert cops.KERNEL_LAUNCHES["conv1d"] == launches + 1


@pytest.mark.parametrize("tracks,s,l", [(6, 16, 40), (8, 64, 7)])
def test_conv_kernel_meets_the_golden_in_bleed(cuda, tracks, s, l):
    """Bleed reads back across as many tracks as L - 1 > S needs, as the
    golden does."""
    x, ir = _conv_inputs(tracks, s, l, cuda)
    got = cops.conv1d_direct(x, ir, "bleed").cpu().numpy()
    ref = conv1d_reference(x.cpu().numpy(), ir.cpu().numpy(), "bleed")
    np.testing.assert_allclose(got, ref, atol=CONV_ATOL, rtol=0)


def test_conv_kernel_is_deterministic(cuda):
    x, ir = _conv_inputs(512, 512, 1024, cuda)
    assert torch.equal(cops.conv1d_direct(x, ir, "bleed"),
                       cops.conv1d_direct(x, ir, "bleed"))


def test_conv_wrapper_rejects_bad_input(cuda):
    x, ir = _conv_inputs(8, 64, 7, cuda)
    with pytest.raises(TypeError, match="float32"):
        cops.conv1d_direct(x.double(), ir)
    with pytest.raises(ValueError, match="contiguous"):
        cops.conv1d_direct(x.t().contiguous().t(), ir)
    with pytest.raises(ValueError, match="on cpu"):
        cops.conv1d_direct(x, ir.cpu())
    with pytest.raises(ValueError, match="edge mode"):
        cops.conv1d_direct(x, ir, "wrap")


# -- the RndMem gather (csrc/rndmem.cu): bit for bit against its twin ----

RNDMEM_POOL = 64 * 1024
RNDMEM_EDGE = [0, 1024, 513, 1000, RNDMEM_POOL - 512, 2047, 12345, 777, 128,
               127, 129, RNDMEM_POOL - 513, RNDMEM_POOL - 640, 255,
               RNDMEM_POOL - 768, 511,
               # clamped: past P - S, and negative (counted from the end)
               RNDMEM_POOL - 1, RNDMEM_POOL + 99, -1, -70000, 2 ** 31 - 1]


@pytest.mark.parametrize("tracks,s", [(21, 512), (77, 100), (4096, 512),
                                      (3, 1)])
def test_rndmem_kernel_matches_plain_twin(cuda, tracks, s):
    g = np.random.Generator(np.random.MT19937(tracks + s))
    pool = torch.from_numpy(g.random(RNDMEM_POOL, dtype=np.float32)).to(cuda)
    ph = g.integers(0, RNDMEM_POOL - s, tracks).astype(np.int32)
    ph[:min(tracks, len(RNDMEM_EDGE))] = RNDMEM_EDGE[:tracks]
    ph = torch.from_numpy(ph).to(cuda)
    launches = rops.KERNEL_LAUNCHES["rndmem_gather"]
    got = rops.rndmem_gather(pool, ph, s)
    want = rops.rndmem_gather_plain(pool, ph, s)
    torch.cuda.synchronize()
    assert got.shape == (s, tracks)
    assert torch.equal(got, want)
    assert rops.KERNEL_LAUNCHES["rndmem_gather"] == launches + 1


def test_rndmem_wrapper_rejects_bad_input(cuda):
    pool = torch.zeros(1024, device=cuda)
    ph = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        rops.rndmem_gather(pool, ph.long(), 64)
    with pytest.raises(ValueError, match="on cpu"):
        rops.rndmem_gather(pool, ph.cpu(), 64)


# -- the DWG block (csrc/dwg.cu) against its twin -----------------------
#
# Rails 1e-6 absolute (each cell is the twin's chain of rounded products
# and sums, so they agree bit for bit unless a step contracts); the mono
# output 1e-5 of the twin's peak (summed over waveguides in another
# order). Random rails U(0, 0.1), so the out-tap pairs carry energy.

DWG_SHAPES = [(6, 48, (5, 8, 12, 16, 33, 40)), (1000, 512, None),
              (333, 64, None), (257, 2000, None)]


def _dwg_inputs(g_count, s, lengths, device, pow2=False, lmax=2000):
    g = np.random.Generator(np.random.MT19937(g_count + s))
    if lengths is None:
        lengths = 100 + g.integers(0, lmax - 100, g_count)
    lengths = np.asarray(lengths)
    if pow2:
        lengths = 2 ** np.floor(np.log2(lengths))
    lengths = lengths.astype(np.int32)
    lmax = max(lmax if lengths.max() > 64 else 40, int(lengths.max()))
    params = [lengths, (lengths // 4).astype(np.int32),
              (3 * lengths // 4).astype(np.int32),
              (0.1 + 0.9 * g.random(g_count, dtype=np.float32)),
              (0.99 + 0.01 * (g.random(g_count, dtype=np.float32) - 0.5)),
              (0.9999 + 1e-4 * (g.random(g_count, dtype=np.float32) - 0.5))]
    x = (g.random(s, dtype=np.float32) * 2 - 1)
    fwd = g.random((g_count, lmax), dtype=np.float32) * np.float32(0.1)
    bwd = g.random((g_count, lmax), dtype=np.float32) * np.float32(0.1)
    return [torch.from_numpy(np.ascontiguousarray(a, a.dtype)).to(device)
            for a in [x, fwd, bwd] + [p.astype(p.dtype) for p in params]]


@pytest.mark.parametrize("pow2", [False, True])
@pytest.mark.parametrize("g_count,s,lengths", DWG_SHAPES)
def test_dwg_kernel_matches_plain_twin(cuda, g_count, s, lengths, pow2):
    x, fwd, bwd, *params = _dwg_inputs(g_count, s, lengths, cuda, pow2)
    fk, bk, fp, bp = fwd.clone(), bwd.clone(), fwd, bwd
    launches = dops.KERNEL_LAUNCHES["dwg_block"]
    for _ in range(2):
        ok, fk, bk = dops.dwg_block(x, fk, bk, *params)
        op_, fp, bp = dops.dwg_block_plain(x, fp, bp, *params)
        torch.cuda.synchronize()
        assert (fk - fp).abs().max().item() <= 1e-6
        assert (bk - bp).abs().max().item() <= 1e-6
        peak = op_.abs().max().item()
        # An out tap past the block's last sample is not reached.
        assert (peak > 0) == (s > int(params[2].min().item()))
        assert (ok - op_).abs().max().item() <= 1e-5 * peak
    assert dops.KERNEL_LAUNCHES["dwg_block"] == launches + 2


def test_dwg_kernel_meets_the_golden(cuda):
    args = _dwg_inputs(6, 48, (5, 8, 12, 16, 33, 40), cuda)
    g_out, g_f, g_b = dwg_reference(*(a.cpu().numpy() for a in args))
    out, f, b = dops.dwg_block(*args)
    assert np.array_equal(f.cpu().numpy(), g_f)
    assert np.array_equal(b.cpu().numpy(), g_b)
    np.testing.assert_allclose(out.cpu().numpy(), g_out, atol=1e-5, rtol=0)


def test_dwg_kernel_is_deterministic_and_in_place(cuda):
    x, fwd, bwd, *params = _dwg_inputs(1000, 512, None, cuda)
    a = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    b = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    _, f, bw = dops.dwg_block(x, fwd, bwd, *params)
    assert f.data_ptr() == fwd.data_ptr() and torch.equal(f, a[1])


# The redesigned kernel (one thread a closed cell pair, the out-tap pairs
# in mono blocks): rails bit for bit the twin's, and the mono output bit
# for bit ``dwg_mono_in_order`` (its order emulated in NumPy), chained over
# 2 blocks, at the edge lengths 1, 2, S - 1, S, S + 1, 2S - 1, odd, an out
# tap at or past S and in tap = out tap (every 7th row), at S = 48, 512 and
# 2,000, and past 65,535 waveguides. (waveguides, S, Lmax, lengths tiled
# over the rows or None for U[100, Lmax), in tap = out tap every 7th row.)
# The edge lengths are chip_smoke.py's.
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
try:
    from chip_smoke import DWG_EDGE_48, DWG_EDGE_512, DWG_EDGE_2000
finally:
    sys.path.pop(0)
DWG_EXACT_SHAPES = [(6, 48, 40, [5, 8, 12, 16, 33, 40], False),
                    (300, 48, 100, DWG_EDGE_48, True),
                    (1000, 512, 1100, DWG_EDGE_512, True),
                    (333, 2000, 4000, DWG_EDGE_2000, True),
                    (1000, 512, 2000, None, False),
                    (257, 2000, 2000, None, False),
                    (70000, 512, 600, None, False)]


def _dwg_exact_inputs(g_count, s, lmax, lengths, same_tap, device):
    g = np.random.Generator(np.random.MT19937(g_count + s + 1))
    if lengths is None:
        lengths = 100 + g.integers(0, lmax - 100, g_count)
    lengths = np.resize(np.asarray(lengths), g_count).astype(np.int32)
    in_taps = (lengths // 4).astype(np.int32)
    out_taps = (3 * lengths // 4).astype(np.int32)
    if same_tap:
        in_taps[::7] = out_taps[::7]
    f32 = np.float32
    arrays = [(g.random(s, dtype=f32) * 2 - 1).astype(f32),
              g.random((g_count, lmax), dtype=f32) * f32(0.1),
              g.random((g_count, lmax), dtype=f32) * f32(0.1),
              lengths, in_taps, out_taps,
              (0.1 + 0.9 * g.random(g_count, dtype=f32)).astype(f32),
              (0.99 + 0.01 * (g.random(g_count, dtype=f32) - 0.5)).astype(f32),
              (0.9999 + 1e-4 * (g.random(g_count, dtype=f32) - 0.5)).astype(f32)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("g_count,s,lmax,lengths,same_tap", DWG_EXACT_SHAPES)
def test_dwg_kernel_is_bit_exact(cuda, g_count, s, lmax, lengths, same_tap):
    x, fwd, bwd, *params = _dwg_exact_inputs(g_count, s, lmax, lengths,
                                             same_tap, cuda)
    host = [p.cpu().numpy() for p in params]
    fk, bk, fp, bp = fwd.clone(), bwd.clone(), fwd, bwd
    peak = 0.0
    for _ in range(2):
        want = dops.dwg_mono_in_order(x.cpu().numpy(), fk.cpu().numpy(),
                                      bk.cpu().numpy(), *host)
        ok, fk, bk = dops.dwg_block(x, fk, bk, *params)
        _, fp, bp = dops.dwg_block_plain(x, fp, bp, *params)
        torch.cuda.synchronize()
        assert torch.equal(fk, fp) and torch.equal(bk, bp)
        assert np.array_equal(ok.cpu().numpy(), want)
        peak = max(peak, float(np.abs(want).max()))
    assert peak > 0
    again = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    first = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_dwg_kernel_leaves_rows_outside_the_rails_untouched(cuda):
    x, fwd, bwd, *params = _dwg_exact_inputs(300, 48, 100, DWG_EDGE_48, True,
                                             cuda)
    bad = torch.tensor([0, 17, 130, 299])
    params[0][bad] = torch.tensor([0, -3, 101, 1 << 30], dtype=torch.int32,
                                  device=cuda)
    good = torch.ones(300, dtype=torch.bool)
    good[bad] = False
    good = good.to(cuda)
    fk, bk = fwd.clone(), bwd.clone()
    out, fk, bk = dops.dwg_block(x, fk, bk, *params)
    torch.cuda.synchronize()
    assert torch.equal(fk[~good], fwd[~good]) and torch.equal(bk[~good], bwd[~good])
    sub = [p[good].contiguous() for p in params]
    want, fp, bp = dops.dwg_block_plain(x, fwd[good].clone(), bwd[good].clone(), *sub)
    assert torch.equal(fk[good], fp) and torch.equal(bk[good], bp)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_dwg_kernel_on_a_side_stream(cuda):
    """The fold kernel follows the block kernel in stream order: several
    calls queued on a side stream give the default stream's results."""
    x, fwd, bwd, *params = _dwg_exact_inputs(1000, 512, 1100, DWG_EDGE_512,
                                             True, cuda)
    want = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
               for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for g in got:
        assert all(torch.equal(u, v) for u, v in zip(g, want))


def test_dwg_launch_refuses_a_schedule_that_misses_the_shape(cuda):
    x, fwd, bwd, *params = _dwg_exact_inputs(1000, 512, 1100, DWG_EDGE_512,
                                             False, cuda)
    sc = dops.dwg_schedule(1000, 512, 1100)
    ops = gpuab.load()
    rails = (fwd.clone(), bwd.clone())
    for bad in ((sc.segments - 1, sc.groups, sc.update_blocks),
                (sc.segments + 1, sc.groups, sc.update_blocks),
                (sc.segments, sc.groups - 1, sc.update_blocks),
                (sc.segments, sc.groups, sc.update_blocks - 1)):
        with pytest.raises(RuntimeError, match="dwg_block_launch failed"):
            ops.dwg_block_launch(x, fwd, bwd, *params, *bad)
    torch.cuda.synchronize()
    # Refused before the launch: the rails are untouched.
    assert torch.equal(fwd, rails[0]) and torch.equal(bwd, rails[1])
    ops.dwg_block_launch(x, fwd, bwd, *params, sc.segments, sc.groups,
                         sc.update_blocks)
    torch.cuda.synchronize()


# -- the FDTD kernels (csrc/fdtd3d.cu) against their twins --------------
#
# Each within 1e-5 of the twin's peak (outputs and fields; the kernels
# round every step as the twins do, so they should agree bit for bit),
# fields chained over 2 blocks; and the divergence kernel against the
# field kernel within 1e-5 of the peak (the reference's cross-check).


def _fdtd_x(tracks, s, device, seed=3):
    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _rel(got, want):
    peak = want.abs().max().item()
    return (got - want).abs().max().item() / max(peak, 1e-30)


@pytest.mark.parametrize("room,s", [(8, 64), (14, 17), (30, 8)])
def test_fdtd_kernels_match_plain_twins(cuda, room, s):
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    x = _fdtd_x(4, s, cuda)
    dk = dp = fops.zero_fields_div(n, cuda)
    fk = fp = fops.zero_fields(n, cuda)
    before = dict(fops.KERNEL_LAUNCHES)
    for _ in range(2):
        out_dk, *dk = fops.fdtd3d_block_div(x, *dk, src, rcv)
        out_dp, *dp = fops.fdtd3d_block_div_plain(x, *dp, src, rcv)
        out_fk, *fk = fops.fdtd3d_block_field(x, *fk, src, rcv)
        out_fp, *fp = fops.fdtd3d_block_field_plain(x, *fp, src, rcv)
        torch.cuda.synchronize()
        for got, want in [(out_dk, out_dp), (out_fk, out_fp),
                          *zip(dk, dp), *zip(fk, fp), (out_dk, out_fk),
                          (dk[0], fk[0])]:
            assert got.shape == want.shape
            assert _rel(got, want) <= 1e-5
    assert out_dk.abs().max().item() > 0  # heard by the second block
    assert fops.KERNEL_LAUNCHES["fdtd3d_div"] == before["fdtd3d_div"] + 2
    assert fops.KERNEL_LAUNCHES["fdtd3d_field"] == before["fdtd3d_field"] + 2


@pytest.mark.parametrize("tracks", [1, 7, 128])
def test_fdtd_per_track_receivers_match_twin(cuda, tracks):
    room, s = 14, 24
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    xs, ys, zs = fops.receiver_line(tracks, n)
    cells = torch.from_numpy(
        ((xs.astype(np.int64) * n + ys) * n + zs).astype(np.int32)).to(cuda)
    x = _fdtd_x(tracks, s, cuda)
    got = fops.fdtd3d_block_field(x, *fops.zero_fields(n, cuda), src, rcv,
                                  receivers=cells)
    want = fops.fdtd3d_block_field_plain(x, *fops.zero_fields(n, cuda), src,
                                         rcv, receivers=cells)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5
    assert got[0].shape == (tracks, s)


def test_fdtd_receiver_on_the_source_cell(cuda):
    """A receiver on the source cell reads the value before the next
    sample's injection, as the twin does."""
    room, s = 8, 12
    n, src = fops.grid_n(room), fops.source_pos(room)
    x = _fdtd_x(2, s, cuda)
    for kern, plain, zero in (
            (fops.fdtd3d_block_div, fops.fdtd3d_block_div_plain,
             fops.zero_fields_div),
            (fops.fdtd3d_block_field, fops.fdtd3d_block_field_plain,
             fops.zero_fields)):
        got = kern(x, *zero(n, cuda), src, src)
        want = plain(x, *zero(n, cuda), src, src)
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-5


def test_fdtd_kernels_are_deterministic(cuda):
    room = 50
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    x = _fdtd_x(8, 64, cuda)
    a = fops.fdtd3d_block_div(x, *fops.zero_fields_div(n, cuda), src, rcv)
    b = fops.fdtd3d_block_div(x, *fops.zero_fields_div(n, cuda), src, rcv)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# -- the divergence form's two routes (ops.fdtd3d.fdtd_schedule) -------
#
# The cluster kernel against the twin and against the plane kernel
# at the same room, bit for bit (every product, sum and difference is
# rounded on its own, in the twin's order), fields chained over 2 blocks.


def _last_cluster_room():
    """The largest room the schedule puts on the cluster route."""
    return max(r for r in range(1, 130)
               if fops.fdtd_schedule(fops.grid_n(r), "div").route == "cluster")


def _div_case(room, s, tracks, receiver, device):
    """x and the geometry, the receiver "default" (the room's receiver
    cell), "source" (on the source cell) or "boundary" (on the first cell
    of the schedule's fourth range)."""
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    if receiver == "source":
        rcv = src
    elif receiver == "boundary":
        c = fops.fdtd_schedule(n, "div").ranges[3][0]
        rcv = (c // (n * n), c // n % n, c % n)
    return _fdtd_x(tracks, s, device), n, src, rcv


def _div_chain(fn, x, n, src, rcv, device, blocks=2):
    fields = fops.zero_fields_div(n, device)
    outs = []
    for _ in range(blocks):
        got = fn(x, *fields, src, rcv)
        outs.append(got)
        fields = got[1:]
    return outs


def _same(a, b):
    return all(torch.equal(u, v) for pa, pb in zip(a, b)
               for u, v in zip(pa, pb))


# (room, samples, tracks, receiver): the smallest room (1: 2 blocks of 13
# and 14 cells), room 8 with the receiver on the source cell, room 15's
# ragged ranges (307 and 308 cells) with the receiver on a range boundary
# and S odd, room 50 with 128 tracks.
FDTD_ROUTE_CASES = [(1, 6, 2, "default"), (8, 12, 4, "source"),
                    (15, 7, 4, "boundary"), (50, 9, 128, "default")]


@pytest.mark.parametrize("room,s,tracks,receiver", FDTD_ROUTE_CASES)
def test_fdtd_cluster_route_matches_twin_and_coop_bit_for_bit(
        cuda, room, s, tracks, receiver):
    x, n, src, rcv = _div_case(room, s, tracks, receiver, cuda)
    assert fops.fdtd_schedule(n, "div").route == "cluster"
    before = dict(fops.KERNEL_LAUNCHES)
    clu = _div_chain(fops.fdtd3d_block_div_cluster, x, n, src, rcv, cuda)
    coop = _div_chain(fops.fdtd3d_block_div_coop, x, n, src, rcv, cuda)
    twin = _div_chain(fops.fdtd3d_block_div_plain, x, n, src, rcv, cuda)
    again = _div_chain(fops.fdtd3d_block_div, x, n, src, rcv, cuda)
    torch.cuda.synchronize()
    assert _same(clu, twin) and _same(coop, twin) and _same(clu, again)
    assert clu[1][0].abs().max().item() > 0
    assert fops.KERNEL_LAUNCHES["fdtd3d_div"] == before["fdtd3d_div"] + 4
    assert (fops.KERNEL_LAUNCHES["fdtd3d_div_coop"]
            == before["fdtd3d_div_coop"] + 2)


def test_fdtd_routes_at_the_schedule_edge(cuda):
    """The largest room on the cluster route takes it, bit for bit the
    twin's and the plane kernel's; the next room takes the plane route,
    and the cluster launcher refuses it."""
    room = _last_cluster_room()
    for r, key in ((room, "fdtd3d_div"), (room + 1, "fdtd3d_div_coop")):
        x, n, src, rcv = _div_case(r, 3, 2, "default", cuda)
        before = fops.KERNEL_LAUNCHES[key]
        got = _div_chain(fops.fdtd3d_block_div, x, n, src, rcv, cuda)
        twin = _div_chain(fops.fdtd3d_block_div_plain, x, n, src, rcv, cuda)
        coop = _div_chain(fops.fdtd3d_block_div_coop, x, n, src, rcv, cuda)
        torch.cuda.synchronize()
        assert _same(got, twin) and _same(coop, twin)
        assert fops.KERNEL_LAUNCHES[key] >= before + 2
    with pytest.raises(ValueError, match="does not fit"):
        fops.fdtd3d_block_div_cluster(x, *fops.zero_fields_div(n, cuda), src,
                                      rcv)


def test_fdtd_cluster_launch_refuses_ranges_it_cannot_carry(cuda):
    """The C launcher checks the ranges it is given: they cover the grid
    in order, each of at least n^2 cells, balanced within one cell."""
    n, s, tracks = fops.grid_n(8), 4, 2
    plan = fops.fdtd_schedule(n, "div")
    lib = fops._lib()
    starts = list(fops.range_starts(plan))
    x = _fdtd_x(tracks, s, cuda)
    src = fops.source_row(x)
    p, div = fops.zero_fields_div(n, cuda)
    outs = [torch.empty_like(p), torch.empty_like(div),
            torch.empty((tracks, s), device=cuda)]
    bad = [starts[:-1] + [starts[-1] - 1],  # short of the grid
           [0, starts[2], starts[1]] + starts[3:],  # out of order
           [0, n * n - 1] + starts[2:],  # a range under n^2 cells
           [0, starts[1] + 2] + starts[2:]]  # unbalanced
    for st in [starts] + bad:
        arr = (ctypes.c_int * len(st))(*st)
        err = lib.fdtd_div_cluster_launch(
            src.data_ptr(), p.data_ptr(), div.data_ptr(),
            *(o.data_ptr() for o in outs), n, s, 0, tracks, 0, fops.K1,
            fops.K2, fops.C6, fops.ABSORB, fops.F_OUTPUT_SCALE, arr,
            plan.blocks, torch.cuda.current_stream(cuda).cuda_stream)
        assert (err == 0) == (st is starts), st
        assert (lib.fdtd_cluster_smem(n, arr, plan.blocks)
                == (plan.smem_bytes if st is starts else -1))
    torch.cuda.synchronize()


def test_fdtd_cluster_probe_runs_and_is_schedulable(cuda):
    n = fops.grid_n(50)
    plan = fops.fdtd_schedule(n, "div")
    assert fops.cluster_occupancy(plan.blocks, plan.smem_bytes, cuda) >= 1
    lib = fops._lib()
    cuts = fops.range_starts(plan)
    starts = (ctypes.c_int * len(cuts))(*cuts)
    assert lib.fdtd_cluster_smem(n, starts, plan.blocks) == plan.smem_bytes
    assert lib.fdtd_cluster_occupancy(n, starts, plan.blocks) >= 1
    fops.cluster_probe(plan.blocks, plan.smem_bytes, 64, cuda)
    torch.cuda.synchronize()


def test_fdtd_cluster_kernel_is_deterministic(cuda):
    x, n, src, rcv = _div_case(50, 16, 8, "default", cuda)
    a = _div_chain(fops.fdtd3d_block_div_cluster, x, n, src, rcv, cuda)
    b = _div_chain(fops.fdtd3d_block_div_cluster, x, n, src, rcv, cuda)
    assert _same(a, b)


# The plane route (a block a plane, the planes handed on through L2) at
# the rooms it serves on the main paths: 66 (the first past the cluster
# route), 82 and 128 (the largest the config allows; S = 32), bit for bit
# the twin, fields chained over 2 blocks, each S long enough for the
# receiver to hear the source in the second block (60, 74 and 116 cells
# apart).
FDTD_PLANE_CASES = [(66, 20), (82, 25), (128, 32)]


@pytest.mark.parametrize("room,s", FDTD_PLANE_CASES)
def test_fdtd_plane_kernel_matches_twin_bit_for_bit(cuda, room, s):
    x, n, src, rcv = _div_case(room, s, 4, "default", cuda)
    plan = fops.fdtd_schedule(n, "div")
    assert plan.route == "planes" and plan.blocks == n
    before = dict(fops.KERNEL_LAUNCHES)
    got = _div_chain(fops.fdtd3d_block_div, x, n, src, rcv, cuda)
    twin = _div_chain(fops.fdtd3d_block_div_plain, x, n, src, rcv, cuda)
    torch.cuda.synchronize()
    assert _same(got, twin)
    assert got[1][0].abs().max().item() > 0
    assert {k: v - before[k] for k, v in fops.KERNEL_LAUNCHES.items()} \
        == {"fdtd3d_div": 0, "fdtd3d_div_coop": 2, "fdtd3d_field": 0,
            "fdtd3d_receiver_buckets": 0}


def test_fdtd_plane_kernel_is_deterministic(cuda):
    x, n, src, rcv = _div_case(82, 16, 8, "default", cuda)
    a = _div_chain(fops.fdtd3d_block_div_coop, x, n, src, rcv, cuda)
    b = _div_chain(fops.fdtd3d_block_div_coop, x, n, src, rcv, cuda)
    assert _same(a, b)


def test_fdtd_plane_launch_refuses_what_it_cannot_carry(cuda):
    """The C launcher takes only the schedule's planes, and only a grid
    the card holds at once: a cooperative launch, refused (never hung)
    past the card's SMs. Its shared memory is the schedule's."""
    lib = fops._lib()
    for room in (66, 82, 128):
        n = fops.grid_n(room)
        assert lib.fdtd_planes_smem(n) == fops.plane_schedule(n).smem_bytes
        assert lib.fdtd_planes_capacity(n) >= n
    n, s, tracks = fops.grid_n(8), 4, 2
    x = _fdtd_x(tracks, s, cuda)
    p, div = fops.zero_fields_div(n, cuda)
    outs = [torch.empty_like(p), torch.empty_like(div),
            torch.empty((tracks, s), device=cuda)]
    xch = torch.empty(2 * (n + 2) * fops.plane_stride(n), device=cuda)
    flags = torch.empty(n * fops.PLANE_FLAG_STRIDE, dtype=torch.int32,
                        device=cuda)
    starts = list(fops.range_starts(fops.plane_schedule(n)))
    bad = [starts[:-1] + [starts[-1] - 1],  # short of the grid
           [0, starts[1] + 1] + starts[2:]]  # not a plane
    for st in [starts] + bad:
        arr = (ctypes.c_int * len(st))(*st)
        err = lib.fdtd_div_planes_launch(
            fops.source_row(x).data_ptr(), p.data_ptr(), div.data_ptr(),
            *(o.data_ptr() for o in outs), xch.data_ptr(), flags.data_ptr(),
            n, s, 0, tracks, 0, fops.K1, fops.K2, fops.C6, fops.ABSORB,
            fops.F_OUTPUT_SCALE, arr, n,
            torch.cuda.current_stream(cuda).cuda_stream)
        assert (err == 0) == (st is starts), st
    torch.cuda.synchronize()
    # 139 planes: a build takes them (19,321 cells a block), the card's
    # SMs do not
    n = 139
    assert 0 < lib.fdtd_planes_capacity(n) < n
    x, big = _fdtd_x(tracks, s, cuda), fops.zero_fields_div(n, cuda)
    before = dict(fops.KERNEL_LAUNCHES)
    with pytest.raises(RuntimeError, match="fdtd_div_planes_launch failed"):
        fops.fdtd3d_block_div_coop(x, *big, (69, 69, 14), (100, 40, 69))
    torch.cuda.synchronize()
    assert fops.KERNEL_LAUNCHES == before


# -- the field form's plane kernel (ops.fdtd3d.plane_schedule) ----------
#
# Bit for bit the twin, outputs and the four fields, chained over 2
# blocks, with 128 per-track receivers along the line (track 0 on the
# source cell) and with the broadcast receiver, at the rooms chip_smoke.py
# holds: 8 and 50 (the faces in registers, 1 and 3 cells a thread), 82
# (the last room so, 7) and 128 (the largest, 17 cells a thread, vy and
# vz in shared memory); S long enough for the receivers to hear the
# source.
FDTD_FIELD_CASES = [(8, 24), (50, 20), (82, 25), (128, 32)]


def _field_receivers(n, src, tracks, device):
    xs, ys, zs = fops.receiver_line(tracks, n)
    cells = ((xs.astype(np.int64) * n + ys) * n + zs).astype(np.int32)
    cells[0] = fops.flat_cell(src, n)
    return torch.from_numpy(cells).to(device)


def _field_chain(fn, x, n, src, rcv, device, receivers, blocks=2):
    fields = fops.zero_fields(n, device)
    outs = []
    for _ in range(blocks):
        got = fn(x, *fields, src, rcv, receivers=receivers)
        outs.append(got)
        fields = got[1:]
    return outs


@pytest.mark.parametrize("room,s", FDTD_FIELD_CASES)
@pytest.mark.parametrize("per_track", [True, False])
def test_fdtd_field_plane_kernel_matches_twin_bit_for_bit(cuda, room, s,
                                                          per_track):
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    plan = fops.fdtd_schedule(n, "field")
    assert plan == fops.plane_schedule(n, "field") and plan.blocks == n
    tracks = 128 if per_track else 4
    x = _fdtd_x(tracks, s, cuda)
    cells = _field_receivers(n, src, tracks, cuda) if per_track else None
    before = dict(fops.KERNEL_LAUNCHES)
    got = _field_chain(fops.fdtd3d_block_field, x, n, src, rcv, cuda, cells)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fops.KERNEL_LAUNCHES.items()} \
        == {"fdtd3d_div": 0, "fdtd3d_div_coop": 0, "fdtd3d_field": 2,
            "fdtd3d_receiver_buckets": 2 if per_track else 0}
    twin = _field_chain(fops.fdtd3d_block_field_plain, x, n, src, rcv, cuda,
                        cells)
    torch.cuda.synchronize()
    assert _same(got, twin)
    assert got[1][0].abs().max().item() > 0
    if per_track:
        assert len(set(got[1][0][:, -1].tolist())) > 1


def test_fdtd_field_plane_kernel_is_deterministic(cuda):
    n, src, rcv = fops.grid_n(50), fops.source_pos(50), fops.receiver_pos(50)
    x = _fdtd_x(128, 16, cuda)
    cells = _field_receivers(n, src, 128, cuda)
    a = _field_chain(fops.fdtd3d_block_field, x, n, src, rcv, cuda, cells)
    b = _field_chain(fops.fdtd3d_block_field, x, n, src, rcv, cuda, cells)
    assert _same(a, b)


def test_fdtd_field_plane_launch_refuses_what_it_cannot_carry(cuda):
    """The C launcher takes only the schedule's planes and grids a build
    takes, and the operator only receivers' buckets of the shapes the
    bucketing kernel gives (n + 1 plane starts, a cell and a row a
    track, int32 on the card): it refuses the others before launching
    anything, and the wrapper then raises and counts no launch. Its
    shared memory is the schedule's, and the card holds its grid, at
    rooms on both layouts."""
    lib = fops._lib()
    for room in (8, 50, 82, 83, 128):
        n = fops.grid_n(room)
        plan = fops.plane_schedule(n, "field")
        assert lib.fdtd_field_planes_smem(n) == plan.smem_bytes
        assert lib.fdtd_field_planes_capacity(n) >= n
    n, s, tracks = fops.grid_n(8), 4, 3
    src, rcv = fops.source_pos(8), fops.receiver_pos(8)
    x = _fdtd_x(tracks, s, cuda)
    fields = fops.zero_fields(n, cuda)
    cells = _field_receivers(n, src, tracks, cuda)
    rows = fops.receiver_buckets(cells, n)
    starts = fops.range_starts(fops.plane_schedule(n, "field"))
    bad_planes = [starts[:-1] + [starts[-1] - 1], [0, starts[1] + 1]
                  + starts[2:]]
    cut, order, rcv_starts = rows
    bad_rows = [(cut, order, rcv_starts[:-1].clone()),
                (cut, order[:-1].clone(), rcv_starts),
                (cut.cpu(), order, rcv_starts),
                (cut, order.to(torch.int64), rcv_starts),
                (cut, None, rcv_starts)]
    ops = gpuab.load()

    def launch(st, rs):
        return ops.fdtd_field_planes_launch(
            fops.source_row(x), *fields, *rs, tracks,
            fops.flat_cell(src, n), fops.flat_cell(rcv, n), fops.K1,
            fops.K2, fops.ABSORB, fops.F_OUTPUT_SCALE, st)

    launch(starts, rows)
    launch(starts, (None, None, None))
    for st in bad_planes:
        with pytest.raises(RuntimeError, match="field_planes_launch failed"):
            launch(st, rows)
    for rs in bad_rows:
        with pytest.raises(RuntimeError, match="fdtd_field_planes_launch"):
            launch(starts, rs)
    with pytest.raises(RuntimeError, match="fdtd_receiver_buckets"):
        ops.fdtd_receiver_buckets(cells.to(torch.int64), n)
    with pytest.raises(RuntimeError, match="fdtd_receiver_buckets failed"):
        ops.fdtd_receiver_buckets(cells, 140)  # more planes than a build
    torch.cuda.synchronize()
    # 132 planes: no build takes 17,424 cells a block (19 a thread); a
    # plan that asks for them anyway is refused before the launch
    n = 132
    assert lib.fdtd_field_planes_smem(n) == -1
    big = fops.FdtdPlan("planes", n, tuple((b * n * n, (b + 1) * n * n)
                                           for b in range(n)), 0)
    x = _fdtd_x(2, 2, cuda)
    src, rcv = (65, 65, 13), (104, 40, 65)
    before = dict(fops.KERNEL_LAUNCHES)
    with pytest.raises(RuntimeError, match="fdtd_field_planes_launch failed"):
        fops._field_op(x, *fops.zero_fields(n, cuda), n, src, rcv, None,
                       big)
    with pytest.raises(ValueError, match="no plane kernel"):
        fops.fdtd3d_block_field(x, *fops.zero_fields(n, cuda), src, rcv)
    torch.cuda.synchronize()
    assert fops.KERNEL_LAUNCHES == before


# -- the per-track receivers bucketed on the card ----------------------
#
# The bucketing kernel against its twin (receiver_buckets_plain): the
# normalized cells and the plane starts bit for bit, each plane's rows as
# a set (the kernel's order within a plane is its shared-memory atomics'),
# at the benchmark's 128 tracks and at 65,536, room 50, cells drawn over
# [-2 n^3, 2 n^3), and at a few tracks in the smallest and the largest
# grid.
BUCKET_CASES = [(128, 52), (65536, 52), (5, 3), (1000, 139)]


def _off_grid_cells(tracks, n, device, seed=5):
    g = np.random.Generator(np.random.MT19937(seed))
    cells = g.integers(-2 * n ** 3, 2 * n ** 3, tracks).astype(np.int32)
    return torch.from_numpy(cells).to(device)


@pytest.mark.parametrize("tracks,n", BUCKET_CASES)
def test_fdtd_receiver_buckets_match_twin(cuda, tracks, n):
    rcv = _off_grid_cells(tracks, n, cuda)
    before = fops.KERNEL_LAUNCHES["fdtd3d_receiver_buckets"]
    cells, order, starts = fops.receiver_buckets(rcv, n)
    torch.cuda.synchronize()
    assert fops.KERNEL_LAUNCHES["fdtd3d_receiver_buckets"] == before + 1
    want = fops.receiver_buckets_plain(rcv.cpu(), n)
    assert torch.equal(cells.cpu(), want[0])
    assert torch.equal(starts.cpu(), want[2])
    got_order, want_order = order.cpu().tolist(), want[1].tolist()
    cuts = want[2].tolist()
    for b in range(n):
        assert (sorted(got_order[cuts[b]:cuts[b + 1]])
                == sorted(want_order[cuts[b]:cuts[b + 1]])), b
    assert sorted(got_order) == list(range(tracks))


# The field kernel on receivers off the grid (the two sets given at room
# 8, then edges and random cells at room 50), bit for bit the twin over 2
# blocks: each row read from the cell the JAX package's gather reads.
FIELD_OFF_GRID = [(8, [503, -1, 7, 100]), (8, [0, 1040, -1009, 12]),
                  (50, None)]


@pytest.mark.parametrize("room,cells", FIELD_OFF_GRID)
def test_fdtd_field_kernel_reads_off_grid_receivers_as_the_twin(cuda, room,
                                                                cells):
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    if cells is None:
        rcvs = _off_grid_cells(128, n, cuda)
        rcvs[:4] = torch.tensor([n ** 3 + 40, -1, -n ** 3 - 9, n ** 3 - 1])
    else:
        rcvs = torch.tensor(cells, dtype=torch.int32, device=cuda)
    x = _fdtd_x(rcvs.numel(), 24, cuda)
    got = _field_chain(fops.fdtd3d_block_field, x, n, src, rcv, cuda, rcvs)
    twin = _field_chain(fops.fdtd3d_block_field_plain, x, n, src, rcv, cuda,
                        rcvs)
    torch.cuda.synchronize()
    assert _same(got, twin)


def test_fdtd_field_block_captures_with_receivers_never_seen(cuda):
    """A field block with a receivers tensor no call has seen captures
    into a CUDA graph (nothing reads the receivers on the host), its
    replay gives the eager block's bits, and a replay after the
    receivers are changed in place reads the new cells."""
    room = 50
    n, src, rcv = (fops.grid_n(room), fops.source_pos(room),
                   fops.receiver_pos(room))
    x = _fdtd_x(128, 16, cuda)
    fields = fops.zero_fields(n, cuda)
    fields[0][26, 26, 6] = 1.0  # a ringing room
    first = _field_receivers(n, src, 128, cuda)
    second = _off_grid_cells(128, n, cuda, seed=9)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm-up, on other receivers
        fops.fdtd3d_block_field(x, *fields, src, rcv, receivers=second)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    fresh = first.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fops.fdtd3d_block_field(x, *fields, src, rcv, receivers=fresh)
    for cells in (first, second):
        fresh.copy_(cells)
        graph.replay()
        torch.cuda.synchronize()
        want = fops.fdtd3d_block_field_plain(x, *fields, src, rcv,
                                             receivers=cells)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert len(set(out[0][:, -1].tolist())) > 1


# The speed-of-light kernels (rows, width, k): against the twin within
# 1e-4 absolute (one rounding a pass against the twin's two: at most
# k * 2^-23 * 2 on values below 2, 1e-4 at k = 512), against the closed
# form within the benchmarks' 5e-4; the last two are SOL_VMEM's and
# SOL_VPU's defaults.
SOL_SHAPES = [(37, 1000, 24), (64, 1024, 130), (8, 128, 0), (3, 5, 1),
              (512, 1024, 512), (2048, 1024, 512)]


def _sol_x(rows, width, device, seed=5):
    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((rows, width), dtype=np.float32) * 2 - 1).astype(np.float32)
    return x, torch.from_numpy(x).to(device)


@pytest.mark.parametrize("name", ["fma_chain", "fma_vmem"])
@pytest.mark.parametrize("rows,width,k", SOL_SHAPES)
def test_sol_kernel_matches_plain_twin(cuda, name, rows, width, k):
    host, x = _sol_x(rows, width, cuda)
    launches = sops.KERNEL_LAUNCHES[name]
    got = getattr(sops, name)(x, k)
    torch.cuda.synchronize()
    assert sops.KERNEL_LAUNCHES[name] == launches + 1
    want = sops.fma_chain_plain(x, k)
    assert got.shape == x.shape and got is not x
    assert (got - want).abs().max().item() <= 1e-4
    golden = sops.fma_golden(host, k)
    assert np.abs(got.cpu().numpy() - golden).max() <= 5e-4


def test_sol_kernels_agree_bit_for_bit(cuda):
    _, x = _sol_x(300, 700, cuda)
    assert torch.equal(sops.fma_chain(x, 77), sops.fma_vmem(x, 77))
    assert torch.equal(sops.fma_chain(x, 0), x)


@pytest.mark.parametrize("name", ["fma_chain", "fma_vmem"])
def test_sol_wrapper_rejects_bad_input(cuda, name):
    fn = getattr(sops, name)
    launches = dict(sops.KERNEL_LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        fn(torch.ones((4, 8), dtype=torch.float64, device=cuda), 3)
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.ones(8, device=cuda), 3)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.ones((8, 4), device=cuda).t(), 3)
    with pytest.raises(ValueError, match="k must be"):
        fn(torch.ones((4, 8), device=cuda), -1)
    assert sops.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
def test_sol_matmul_at_4096_meets_its_golden(cuda, dtype):
    """``matmul_bf16`` (two K halves, each ``out_dtype=torch.float32``),
    full-FP32 ``torch.matmul`` and ``torch._int_mm`` at the default 4,096
    against the f32 and exact integer goldens, every element checked."""
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    cfg = BenchConfig(verification="full")
    bench = create_benchmark(f"SOL_MXU_{dtype}", cfg, cuda)
    bench.setup()
    v = bench.validate()
    assert v.passed, v.messages[:3]
    assert v.samples_checked == 4096 * 4096
    if dtype == "int8":
        assert v.max_error == 0.0


def test_device_tier_tracks_the_profiler_on_rndmem(cuda):
    """The gated device tier's p50 of RndMemRead at 65,536 tracks lies
    within 10 % of the profiler's device time per call."""
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.profile_block import device_tier
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    bench = create_benchmark("RndMemRead", BenchConfig(n_tracks=65536), cuda)
    bench.setup()
    tier = device_tier(bench)
    assert abs(tier["gated_p50_ms"] - tier["profiler_ms_per_call"]) <= (
        0.1 * tier["profiler_ms_per_call"]), tier


# --- pinned staging and the overlapped infeed on the card ---------------


def test_stage_pinned_is_page_locked_and_uploads(cuda):
    from gpuaudiobench_tpu_torch.utils import device as dev

    a = np.arange(1 << 16, dtype=np.float32)
    t = dev.stage_pinned(a, cuda)
    assert t.is_pinned() and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), a)
    up = dev.upload(t, cuda)
    torch.cuda.synchronize()
    assert up.device.type == "cuda" and np.array_equal(up.cpu().numpy(), a)


def _slow_accumulate(x, c):
    """A step slow enough (~0.5 ms of spin first) that an upload that
    did not wait for it would overwrite its slot while it reads."""
    torch.cuda._sleep(1_000_000)
    return x * 2.0, c + x


@pytest.mark.parametrize("loop", ["serial", "overlapped", "batched"])
def test_overlap_loops_are_exact_under_real_concurrency(cuda, loop):
    """Four distinct blocks of small integers through two slots: the
    last output and the summed carry are exact, so a missing event wait
    between the copy stream and the compute shows as a wrong sum."""
    from gpuaudiobench_tpu_torch.harness import overlap

    n, depth = 1 << 20, 24
    blocks = [np.full(n, k + 1, np.float32) for k in range(4)]
    carry = torch.zeros(n, device=cuda)
    if loop == "batched":
        groups = overlap.batch_groups(blocks, 4)
        infeed = overlap.Infeed(groups, cuda)
        y, c = overlap.run_batched(infeed, _slow_accumulate, carry, depth, 4)
        seq = [groups[(k // 4) % 2][k % 4, 0] for k in range(depth)]
    else:
        infeed = overlap.Infeed(blocks, cuda)
        run = overlap.run_serial if loop == "serial" else overlap.run_overlapped
        y, c = run(infeed, _slow_accumulate, carry, depth)
        seq = [blocks[k % 4][0] for k in range(depth)]
    torch.cuda.synchronize()
    assert torch.all(y == 2.0 * seq[-1]).item()
    assert torch.all(c == float(sum(seq))).item()


def test_datacopy_uploads_pinned_and_validates(cuda):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.models.datatransfer import (
        DataTransferBenchmark,
    )

    b = DataTransferBenchmark(BenchConfig(transfer_mib=4), cuda,
                              "datacopy2080")
    b.setup()
    assert b._pinned_input is not None and b._pinned_input.is_pinned()
    assert b.validate().passed
    tmc = b.metadata()["transferMemoryClass"]
    assert tmc["pinned_supported"] and tmc["h2d_path_used"] == "pinned"
    for key in ("h2d_pageable_ms", "h2d_pinned_ms", "d2h_pageable_ms",
                "d2h_pinned_ms"):
        assert tmc[key] > 0, key


# NeuralAmp / NeuralAmpLSTM on the card. The LSTM block runs there as a
# replay of a captured CUDA graph (harness/graph.py), held bit for bit to
# the same block run eagerly on the card. The card's runs against the CPU
# twin: f32 within 1e-5 of the peak (full FP32 both sides, sums in another
# order); bf16 and int8 at the benchmark's own tolerance (one f32 ulp can
# move a bf16 activation by one bf16 step) and each against its golden.
NEURAL_TOY = dict(n_tracks=32, buffer_size=64, neuralamp_channels=32,
                  neuralamp_layers=4, verification="full")


def _neural(device, arch, dtype):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.models.neuralamp import NeuralAmpBenchmark

    b = NeuralAmpBenchmark(BenchConfig(neuralamp_dtype=dtype, **NEURAL_TOY),
                           device, arch)
    b.setup()
    return b


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lstm_graph_block_equals_eager_bit_for_bit(cuda, dtype):
    from gpuaudiobench_tpu_torch.ops import neuralamp as na

    b = _neural(cuda, "lstm", dtype)
    x = b._resident_input
    h, c = (t.clone() for t in b._state)
    run = na.lstm_runner(b._params, dtype, x, h, c)
    before = na.GRAPH_REPLAYS["lstm_block"]
    for _ in range(2):  # a replay rewrites the same outputs
        graphed = [t.clone() for t in run(x, h, c)]
    eager = na.lstm_block(x, h, c, b._params, dtype)
    for g, e in zip(graphed, eager):
        assert torch.equal(g, e)
    assert na.GRAPH_REPLAYS["lstm_block"] == before + 2
    assert b.metadata()["blockForm"] == "cuda-graph"


@pytest.mark.parametrize("arch,dtype", [("tcn", "f32"), ("tcn", "bf16"),
                                        ("tcn", "int8"), ("lstm", "f32"),
                                        ("lstm", "bf16")])
def test_neuralamp_on_the_card_matches_the_cpu_twin(cuda, arch, dtype):
    card, cpu = _neural(cuda, arch, dtype), _neural(torch.device("cpu"),
                                                    arch, dtype)
    for _ in range(3):
        card.iterate()
        cpu.iterate()
    peak = np.abs(cpu.host_output).max()
    rel = 1e-5 if dtype == "f32" else card.tolerance
    assert np.abs(card.host_output - cpu.host_output).max() <= rel * peak
    for b in (card, cpu):
        v = b.validate()
        assert v.passed, v.messages[:3]


def test_captured_block_raises_when_the_capture_fails(cuda):
    """A block that waits for the device (``.item()``) cannot be captured:
    the constructor raises, and nothing runs the block eagerly instead."""
    from gpuaudiobench_tpu_torch.harness.graph import CapturedBlock

    def syncs(x):
        return (x * float(x.sum().item()),)

    with pytest.raises(RuntimeError, match="CapturedBlock"):
        CapturedBlock(syncs, [torch.ones(8, device=cuda)])


# The saturated chain as one CUDA graph (harness/graph.py:ChainGraph): on
# every capturable stream body at a toy size, a replay's probes equal the
# loop's from the same entry carry (bit for bit, or, for a body that runs
# cuBLAS or cuFFT, within its benchmark's tolerance of the peak probe),
# and two replays each other.
CHAIN_TOY = dict(n_tracks=8, buffer_size=64, verification="none",
                 device_timing=False, rndmem_pool_mb=8, sol_fma_k=16,
                 sol_fma_mib=1, sol_stream_mib=1, sol_matmul_dim=128,
                 ir_length=300, neuralamp_channels=16, neuralamp_layers=3,
                 fdtd_room=8, partconv_tail_chunk=2)
CHAIN_BODIES = [
    ("NoOp", {}), ("gain", {}), ("GainStats", {}), ("FFT1D", {}),
    ("IIRFilter", {}), ("IIRFilter", {"iir_form": "blockstate"}),
    ("BiquadChain", {}), ("Conv1D", {}), ("Conv1D", {"conv_edge_mode":
                                                     "bleed"}),
    ("Conv1D_accel", {}), ("ModalFilterBank", {}),
    ("ModalFilterBank", {"modal_renorm": True}), ("DWG1DNaive", {}),
    ("DWG1DAccel", {}), ("FDTD3D", {}),
    ("FDTD3D", {"fdtd_per_track_receivers": True}),
    ("FDTD3D", {"fdtd_room": 66, "buffer_size": 4}), ("RndMemRead", {}),
    ("PartConv", {}), ("PartConv", {"partconv_form": "ring"}),
    ("PartConv", {"partconv_form": "nupols"}),
    ("PartConv", {"partconv_h_dtype": "f16"}), ("DAWSessionMix", {}),
    ("NeuralAmp", {}), ("NeuralAmp", {"neuralamp_dtype": "bf16"}),
    ("NeuralAmp", {"neuralamp_dtype": "int8"}), ("SOL_VPU", {}),
    ("SOL_VMEM", {}), ("SOL_HBM", {}), ("SOL_MXU_bf16", {}),
    ("SOL_MXU_f32", {}), ("SOL_MXU_int8", {}), ("MultiChipSuite", {}),
    ("ICIBandwidth", {"transfer_mib": 1}),
]
CHAIN_LIBRARY_BODIES = ("FFT1D", "Conv1D_accel", "PartConv", "DAWSessionMix",
                        "NeuralAmp", "SOL_MXU_bf16", "SOL_MXU_f32",
                        "SOL_MXU_int8", "MultiChipSuite")
CHAIN_DEPTH = 6


def _clone_carry(carry):
    if isinstance(carry, torch.Tensor):
        return carry.clone()
    if isinstance(carry, (tuple, list)):
        return type(carry)(_clone_carry(c) for c in carry)
    return carry


def _body(device, name, knobs):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.utils.device import fp32_convolutions

    fp32_convolutions(device)  # as the CLI runs (MultiChipSuite's FIR)
    b = create_benchmark(name, BenchConfig(**{**CHAIN_TOY, **knobs}), device)
    b.setup()
    return b


@pytest.mark.parametrize("name,knobs", CHAIN_BODIES)
def test_chain_graph_probes_equal_the_loops(cuda, name, knobs):
    from gpuaudiobench_tpu_torch.harness.graph import ChainGraph
    from gpuaudiobench_tpu_torch.harness.streaming import run_chained

    b = _body(cuda, name, knobs)
    assert b.stream_capturable
    step, carry = b.stream_body()
    loop = run_chained(step, _clone_carry(carry), CHAIN_DEPTH)
    g = ChainGraph(step, carry, CHAIN_DEPTH, name=name)
    first, second = g.run(), g.run()
    assert torch.equal(first, second)
    assert first.shape == (CHAIN_DEPTH,) and g.nodes > 0
    if name in CHAIN_LIBRARY_BODIES:
        assert ((first - loop).abs().max()
                <= b.tolerance * loop.abs().max()), (first, loop)
    else:
        assert torch.equal(first, loop), (first, loop)


def _leaves_equal(a, b):
    from gpuaudiobench_tpu_torch.harness.graph import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.mark.parametrize("name,knobs", CHAIN_BODIES)
def test_continuing_graph_equals_the_loop(cuda, name, knobs):
    """The continuing form (the soak's): 3 replays give the carry and the
    probes of 3 * depth eager steps from a clone of the entry carry, bit
    for bit, the cuBLAS / cuFFT bodies' too; a body whose Python values
    come back changed after a chain is refused before anything is
    captured."""
    from gpuaudiobench_tpu_torch.harness.graph import (
        AdvancingCarry,
        ChainGraph,
        python_values,
    )

    b = _body(cuda, name, knobs)
    step, carry = b.stream_body()
    c, eager = _clone_carry(carry), []
    for _ in range(3 * CHAIN_DEPTH):
        c, p = step(c)
        eager.append(p)
        if len(eager) == CHAIN_DEPTH:
            advances = python_values(c) != python_values(carry)
    eager = torch.cat(eager).cpu()
    if advances:
        with pytest.raises(AdvancingCarry, match="Python values"):
            ChainGraph(step, carry, CHAIN_DEPTH, name=name, continuing=True)
        return
    g = ChainGraph(step, carry, CHAIN_DEPTH, name=name, continuing=True)
    got = torch.cat([g.run() for _ in range(3)])
    assert torch.equal(got, eager), (got, eager)
    assert _leaves_equal(g.carry(), c)


def test_continuing_graph_hands_a_swapped_carry_on(cuda):
    """A step that hands one carry tensor on as another leaf (PartConv's
    input becoming ``prev``; a swap) continues as the loop does."""
    from gpuaudiobench_tpu_torch.harness.graph import ChainGraph

    def swap(carry):
        a, b = carry
        return (b + 1.0, a), (a - b).sum().reshape(1)

    entry = (torch.arange(4.0, device=cuda), torch.zeros(4, device=cuda))
    c, eager = _clone_carry(entry), []
    for _ in range(9):
        c, p = swap(c)
        eager.append(p)
    g = ChainGraph(swap, entry, 3, name="swap", continuing=True)
    got = torch.cat([g.run() for _ in range(3)])
    assert torch.equal(got, torch.cat(eager).cpu())
    assert _leaves_equal(g.carry(), c)
    assert torch.equal(entry[0], torch.arange(4.0, device=cuda))  # untouched


def test_soak_reexcites_the_graphs_carry(cuda):
    """The soak's graph form: re-excitation writes the graph's static
    carry in place, and the next replay starts from it, as the loop's
    next block does."""
    from gpuaudiobench_tpu_torch.tools import soak

    b = _body(cuda, "ModalFilterBank", {})
    step, carry = b.stream_body()
    entry = _clone_carry(carry)
    sec = soak.Seconds(step, carry, CHAIN_DEPTH, cuda, name="modal")
    assert sec.form == "cuda-graph"
    sec.run()
    soak.reexcite(sec.carry(), entry)
    got = sec.run()
    c = _clone_carry(entry)
    for _ in range(CHAIN_DEPTH):
        c, _ = step(c)
    soak.reexcite(c, entry)
    eager = []
    for _ in range(CHAIN_DEPTH):
        c, p = step(c)
        eager.append(p)
    assert torch.equal(torch.from_numpy(got), torch.cat(eager).cpu())
    assert _leaves_equal(sec.carry(), c)


def test_chain_graph_raises_when_the_capture_fails(cuda):
    """A step that waits for the device (``.item()``) cannot be captured:
    the constructor raises, naming the chain, and nothing runs the loop
    instead."""
    from gpuaudiobench_tpu_torch.harness.graph import ChainGraph

    def syncs(x):
        return x, (x * float(x.sum().item())).sum().reshape(1)

    with pytest.raises(RuntimeError, match="ChainGraph: capturing 3 blocks "
                       "of toy failed"):
        ChainGraph(syncs, torch.ones(8, device=cuda), 3, name="toy")


def test_chain_graph_launches_are_captured_times_replays(cuda):
    """The wrapper counts the warm chains' launches; the capture records
    one a block, and each replay adds them to REPLAYED_LAUNCHES."""
    from gpuaudiobench_tpu_torch.harness import graph

    b = _body(cuda, "IIRFilter", {})
    step, carry = b.stream_body()
    eager = iops.KERNEL_LAUNCHES["iir_biquad"]
    replayed = graph.REPLAYED_LAUNCHES["iir_biquad"]
    replays = graph.CHAIN_REPLAYS["chain"]
    g = graph.ChainGraph(step, carry, 4, name="IIRFilter")
    assert dict(g.captured) == {"iir_biquad": 4}
    assert (iops.KERNEL_LAUNCHES["iir_biquad"]
            == eager + graph.WARMUP_CALLS * 4)
    for _ in range(3):
        g.run()
    assert graph.REPLAYED_LAUNCHES["iir_biquad"] == replayed + 12
    assert graph.CHAIN_REPLAYS["chain"] == replays + 3
    assert iops.KERNEL_LAUNCHES["iir_biquad"] == eager + graph.WARMUP_CALLS * 4


def test_a_chain_graph_replay_counts_itself(cuda):
    """A replay of the chain's graph itself, not through ``run()``, adds
    one replay and the captured launches, under one ``gpuab.replay`` span;
    the capture records the chain's depth and nodes under its name."""
    from gpuaudiobench_tpu_torch.harness import graph, profiler

    b = _body(cuda, "IIRFilter", {})
    step, carry = b.stream_body()
    g = graph.ChainGraph(step, carry, 4, name="IIRFilter.replay",
                         continuing=True)
    assert graph.CHAINS["IIRFilter.replay"][-1] == {
        "depth": 4, "nodes": g.nodes, "continuing": True}
    replayed = graph.REPLAYED_LAUNCHES["iir_biquad"]
    replays = graph.CHAIN_REPLAYS["chain"]
    profiler.SPANS.reset()
    profiler.enable()
    try:
        g.graph.replay()
    finally:
        profiler.disable()
    torch.cuda.synchronize()
    assert graph.CHAIN_REPLAYS["chain"] == replays + 1
    assert graph.REPLAYED_LAUNCHES["iir_biquad"] == replayed + 4
    assert [r.name for r in profiler.SPANS.records()] == ["gpuab.replay"]
    g.run()
    assert graph.CHAIN_REPLAYS["chain"] == replays + 2
    assert graph.REPLAYED_LAUNCHES["iir_biquad"] == replayed + 8


@pytest.mark.parametrize("name,form", [("gain", "cuda-graph"),
                                       ("PartConv", "cuda-graph"),
                                       ("NeuralAmpLSTM", "loop")])
def test_runner_chain_form_on_the_card(cuda, name, form):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    cfg = BenchConfig(**{**CHAIN_TOY, "n_runs": 2, "warmup": 1,
                         "pipeline_depth": 8, "saturated_reps": 2})
    b = create_benchmark(name, cfg, cuda)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.metadata["chainForm"] == form
    assert len(res.saturated_marginal_latencies) == 2


def test_capture_trace_holds_device_events(cuda, tmp_path):
    """One --capture session writes a trace whose saturated reps hold the
    gain kernels (the elementwise op and the probe), replayed from the
    chain's graphs. Last in the file: a profiler session slows later
    launches."""
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness import profiler
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    cfg = BenchConfig(**{**CHAIN_TOY, "n_runs": 2, "warmup": 1,
                         "pipeline_depth": 8, "saturated_reps": 2,
                         "capture": True, "capture_dir": str(tmp_path)})
    b = create_benchmark("gain", cfg, cuda)
    b.setup()
    run_benchmark(b, cfg, verbose=False)
    path = str(tmp_path / "gain.trace.json")
    assert profiler.trace_events(path)
    reps = profiler.trace_events(path, "saturated-reps")
    assert reps and profiler.summarize(reps, 2 * 10)["device_busy_us_per_block"] > 0


# MultiChipSuite on one rank (mesh 1,1,1) on the card: its step runs the
# biquad and modal kernels and F.conv1d's FP32 FIR; held against the same
# benchmark on the CPU (the plain twins and F.conv1d) at 1e-5 of the
# peak, and the sharded blocks of parallel/ on one rank against their
# single-device blocks on the card at 1e-5 of the peak (FDTD: 5e-3
# absolute, FDTD3D's tolerance, against the field kernel).
MULTICHIP_CFG = dict(n_tracks=256, buffer_size=512, n_runs=1, warmup=0,
                     write_latencies=False, device_timing=False)


def test_multichip_suite_on_the_card_matches_the_cpu(cuda):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.utils.device import fp32_convolutions

    fp32_convolutions(cuda)
    cfg = BenchConfig(**MULTICHIP_CFG)
    before = (iops.KERNEL_LAUNCHES["iir_biquad"],
              tops.KERNEL_LAUNCHES["modal_bank"])
    card = create_benchmark("MultiChipSuite", cfg, cuda)
    card.setup()  # one step: the entry biquad, 2 microbatch stages, 1 bank
    assert (iops.KERNEL_LAUNCHES["iir_biquad"] - before[0],
            tops.KERNEL_LAUNCHES["modal_bank"] - before[1]) == (3, 1)
    cpu = create_benchmark("MultiChipSuite", cfg, torch.device("cpu"))
    cpu.setup()
    got, want = card.host_output, cpu.host_output
    assert got.shape == want.shape == (256, 512)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert card.validate().passed
    assert card.metadata()["collectiveInventory"] == []


def test_multichip_suite_refuses_tf32_convolutions(cuda, monkeypatch):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    b = create_benchmark("MultiChipSuite", BenchConfig(**MULTICHIP_CFG),
                         cuda)
    with pytest.raises(RuntimeError, match="TF32"):
        b.setup()


def _block_inputs(kind):
    from gpuaudiobench_tpu_torch.ops import neuralamp as na

    g = np.random.default_rng(5)
    if kind == "fdtd":
        return (g.uniform(-1, 1, (16, 32)).astype(np.float32),)
    if kind == "partconv":
        return (g.standard_normal((4, 1024)).astype(np.float32),
                [g.standard_normal((4, 128)).astype(np.float32)
                 for _ in range(10)])
    xs = [g.uniform(-1, 1, (8, 64)).astype(np.float32) for _ in range(2)]
    if kind == "tcn":
        return (na.init_params(42, 32, 4), 4, xs)
    return (na.init_lstm_params(42, 32), xs)


@pytest.mark.parametrize("kind", ["fdtd", "partconv", "tcn", "lstm"])
def test_one_rank_sharded_blocks_match_the_single_device_blocks(cuda, kind):
    from gpuaudiobench_tpu_torch.ops import neuralamp as na
    from gpuaudiobench_tpu_torch.ops import partconv as pc
    from gpuaudiobench_tpu_torch.parallel import ranks

    inputs = _block_inputs(kind)
    ours = ranks.BLOCKS[kind](*inputs, device="cuda")
    if kind == "fdtd":
        x = torch.from_numpy(inputs[0]).to(cuda)
        want, *_ = fops.fdtd3d_block_field(x, *fops.zero_fields(device=cuda))
        want = want.cpu().numpy()
        assert np.abs(ours - want).max() <= 5e-3
        return
    if kind == "partconv":
        ir, xs = inputs
        h_re, h_im = pc.partition_spectra(torch.from_numpy(ir).to(cuda), 128)
        f_re = f_im = torch.zeros_like(h_re)
        prev = torch.zeros((4, 128), device=cuda)
        for o, x in zip(ours, xs):
            x = torch.from_numpy(x).to(cuda)
            y, f_re, f_im = pc.partconv_block(x, prev, f_re, f_im, h_re, h_im)
            prev = x
            y = y.cpu().numpy()
            assert np.abs(o - y).max() <= 1e-5 * np.abs(y).max()
        return
    if kind == "tcn":
        params, layers, xs = inputs
        cp = na.cast_params(params, "f32", cuda)
        tails = na.init_tails(8, 32, layers, device=cuda)
        for o, x in zip(ours[0], xs):
            y, tails = na.tcn_block(torch.from_numpy(x).to(cuda), tails, cp,
                                    layers)
            y = y.cpu().numpy()
            assert np.abs(o - y).max() <= 1e-5 * np.abs(y).max()
        return
    params, xs = inputs
    cp = na.cast_lstm_params(params, "f32", cuda)
    h = c = torch.zeros((8, 32), device=cuda)
    run = na.lstm_runner(cp, "f32", torch.from_numpy(xs[0]).to(cuda), h, c)
    for o, x in zip(ours[0], xs):
        y, h, c = (t.clone() for t in run(torch.from_numpy(x).to(cuda), h, c))
        y = y.cpu().numpy()
        assert np.abs(o - y).max() <= 1e-5 * np.abs(y).max()


# -- the examples' paths on the card (gpuaudiobench_tpu_torch/examples) ----
#
# The bell: the first caller of the rotation kernel with |rotation| < 1,
# at T_out = 1 and M = 2,048, where modal_schedule halves the modes a
# thread. Every one of its 375 blocks (4 s) within OUT_RTOL / STATE_ATOL
# of the plain twin run from the kernel's own input state, the strike
# landing between two launches at the checkpoint block; the whole stream
# within 1e-4 of the peak (the benchmark's modal bar) of a stream that
# only the twin ran; and the example's checkpoint/resume bit for bit on
# the card. The room: the example's first 8 blocks against the twin's,
# within 1e-5 of the peak (the FDTD kernels' bar above).


def test_bell_blocks_match_plain_twin(cuda, tmp_path):
    from gpuaudiobench_tpu_torch.examples import streaming_synth as ex

    amp, cos_w, sin_w, re0, im0 = ex.bell_modes(2048)
    n_blocks, half = ex.blocks_for(4.0)
    assert n_blocks == 375
    kick = ex.strike(amp)
    stream, carry = ex.make_stream(amp, cos_w, sin_w, re0, im0, cuda)
    twin = ex.make_stream(amp, cos_w, sin_w, re0, im0,
                          torch.device("cpu"))[0]
    plain = twin.carry0
    before = tops.KERNEL_LAUNCHES["modal_bank"]
    got, alone = [], []
    for b in range(n_blocks):
        if b == half:
            carry, plain = ex.kicked(carry, kick), ex.kicked(plain, kick)
        entry = [t.cpu() for t in carry]
        out, *carry = tops.modal_folded_step(stream.cos_w, stream.sin_w,
                                             *carry, 512, 1)
        want, *wstate = tops.modal_folded_step_plain(
            twin.cos_w, twin.sin_w, *entry, 512, 1)
        out = out.cpu()
        assert (out - want).abs().max() <= OUT_RTOL * want.abs().max()
        for k, w in zip(carry, wstate):
            assert (k.cpu() - w).abs().max() <= STATE_ATOL
        got.append(out[:, 0])
        o, *plain = tops.modal_folded_step_plain(twin.cos_w, twin.sin_w,
                                                 *plain, 512, 1)
        alone.append(o[:, 0])
    assert tops.KERNEL_LAUNCHES["modal_bank"] == before + n_blocks
    got, alone = torch.cat(got), torch.cat(alone)
    assert (got - alone).abs().max() <= 1e-4 * alone.abs().max()
    audio, resumed = ex.render(4.0, 2048, 220.0,
                               str(tmp_path / "bell.state.npz"), cuda)
    assert resumed
    assert np.array_equal(audio, got.numpy())


def test_room_impulse_blocks_match_plain_twin(cuda):
    from gpuaudiobench_tpu_torch.examples import room_impulse as ex

    before = fops.KERNEL_LAUNCHES["fdtd3d_div"]
    got = ex.render(8, cuda)
    assert fops.KERNEL_LAUNCHES["fdtd3d_div"] == before + 8
    p, div = fops.zero_fields_div(fops.GRID_N, cuda)
    x = torch.zeros((1, 512), device=cuda)
    x[0, 0] = 1.0
    want = []
    for k in range(8):
        out, p, div = fops.fdtd3d_block_div_plain(
            x if k == 0 else torch.zeros_like(x), p, div)
        want.append(out[0].cpu().numpy())
    want = np.concatenate(want)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert ex.physics(got)[0] == 21
