"""The hand-written CUDA modal kernel against its plain PyTorch twin, on
the GPU. Marked ``cuda``: each test skips where there is no CUDA device.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: outputs max|kernel - plain| <= 1e-5 * max|plain| (the kernel
sums modes in another order and contracts the rotation into FMAs);
states 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu_torch.ops import modal as tops

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


@pytest.mark.parametrize("m,s,t_out", [
    (4096, 32, 32), (960, 64, 32), (256, 32, 8), (33024, 40, 16), (64, 7, 1),
])
def test_kernel_matches_plain_twin(cuda, m, s, t_out):
    amp, cw, sw, re, im = _tables(m, cuda)
    launches = tops.KERNEL_LAUNCHES
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
    assert tops.KERNEL_LAUNCHES == launches + 3


def test_kernel_is_deterministic(cuda):
    amp, cw, sw, re, im = _tables(70016, cuda)
    a = tops.modal_folded_step(cw, sw, amp * re, amp * im, 64, 32)
    b = tops.modal_folded_step(cw, sw, amp * re, amp * im, 64, 32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("t_out", [3, 64])
def test_kernel_rejects_tracks_not_dividing_32(cuda, t_out):
    tabs = _tables(192, cuda)
    with pytest.raises(ValueError, match="dividing 32"):
        tops.modal_bank(*tabs, 16, t_out)
