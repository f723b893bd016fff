"""The hand-written CUDA kernels (the modal bank in its rotation and
resonator forms, the four IIR kernels and the Conv1D FIR) against their
plain PyTorch twins, on the GPU. Marked ``cuda``: each test skips where
there is no CUDA device.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Modal tolerance: outputs max|kernel - plain| <= 1e-5 * max|plain| (the
kernel sums modes in another order and contracts the rotation into
FMAs); states 1e-5 absolute. The resonator kernel rounds like its twin
mode by mode, so the same bars hold, and 1e-5 of the peak against
``modal_reference_gs`` (the reference's bar, tests/test_pallas_ops.py:432).
The IIR and Conv1D tolerances are stated at their tests below.
"""

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu_torch.models.conv1d import conv1d_reference
from gpuaudiobench_tpu_torch.models.modal import modal_reference_gs
from gpuaudiobench_tpu_torch.ops import conv as cops
from gpuaudiobench_tpu_torch.ops import iir as iops
from gpuaudiobench_tpu_torch.ops import modal as tops
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


# -- the four IIR kernels (csrc/iir.cu) against their plain twins --------
#
# Tolerance: 1e-5 absolute on outputs and states, kernel vs twin. The
# kernels contract the recurrence into FMAs and the blockstate kernel sums
# its chunk product in another order than torch.matmul, each ~1e-7 on
# these unit-scale signals; 1e-5 is the reference's own bar for the
# blockstate form against the scan (tests/test_pallas_ops.py:526).
# Systolic vs chain cascade: 1e-6 absolute and relative, the reference's
# cross-check (tests/test_pallas_ops.py:165-191).

IIR_ATOL = 1e-5
CASCADE_TOL = 1e-6
IIR_SHAPES = [(8, 64), (640, 128), (65536, 512)]
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


IIR_CASES = [("iir_biquad", 128), ("iir_biquad_blockstate", 16),
             ("iir_biquad_blockstate", 128), ("iir_cascade", 128),
             ("iir_cascade_chain", 128)]


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


@pytest.mark.parametrize("tracks,s", [(640, 128), (65536, 512), (33, 7)])
def test_iir_cascade_systolic_matches_chain(cuda, tracks, s):
    x, c, z = _iir_inputs(tracks, s, cuda, k=N_STAGES)
    zs, zc = z, z
    for _ in range(3):
        ys, zs = iops.iir_cascade(x, c, zs)
        yc, zc = iops.iir_cascade_chain(x, c, zc)
        torch.testing.assert_close(ys, yc, atol=CASCADE_TOL, rtol=CASCADE_TOL)
        torch.testing.assert_close(zs, zc, atol=CASCADE_TOL, rtol=CASCADE_TOL)


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
