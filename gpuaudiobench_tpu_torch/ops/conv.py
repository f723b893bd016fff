"""1-D convolution: direct per-track FIR and FFT (fast) convolution.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/conv.py`` and
``ops/conv_pallas.py``, with the public layout of the JAX functions:
x and out are (T, S) track-major, one IR per track, ir (T, L).

* ``conv1d_direct(x, ir, edge_mode)`` wraps the hand-written CUDA kernel
  (``csrc/conv1d.cu``), which replaces the Pallas ``_conv_kernel``:
  out[t, s] = sum over l of ir[t, l] * xw(t, s - l). Edge modes:
  "clamp" reads zeros before sample 0 of a track; "bleed" reads the flat
  track-major buffer, zeros below its start, so the window reaches back
  across as many earlier tracks as L - 1 > S needs. That is the golden's
  semantics (``models/conv1d.py:conv1d_reference``) and the CUDA
  reference's flat indexing; the JAX package's ``conv1d_direct`` pads
  with the previous track only and misses its own golden when L - 1 > S
  (``ROADMAP.md`` §3).
* ``conv1d_direct_plain`` is its twin: the edge-padded (T, S + L - 1)
  window and a loop over taps in the Pallas kernel's summation order,
  ``acc += ir[:, l] * window_l``.
* ``precompute_ir_spectra`` and ``conv1d_fft`` are Conv1D_accel's fast
  convolution on ``torch.fft`` (cuFFT on the card), as the JAX package
  runs it on XLA's FFT. The spectra stay one complex64 tensor: the JAX
  package's float pair exists only because some PJRT runtimes cannot
  move complex64.

``conv1d_direct`` runs the twin only because its tensors lie on the CPU.
On a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import Dict

import torch

from gpuaudiobench_tpu_torch.ops import gpuab

EDGE_MODES = ("clamp", "bleed")

# Launches of the CUDA kernel, by name, counted by the wrapper where it
# launches it (chip_smoke.py reads it to prove the main path used it).
KERNEL_LAUNCHES: Dict[str, int] = {"conv1d": 0}


def padded_window(x: torch.Tensor, l: int, edge_mode: str) -> torch.Tensor:
    """The (T, S + L - 1) window: L - 1 samples before each track (zeros
    for clamp; the flat buffer's preceding samples, zeros before its
    start, for bleed), then the track."""
    t, s = x.shape
    if edge_mode == "clamp":
        return torch.cat([x.new_zeros((t, l - 1)), x], dim=1)
    flat = torch.cat([x.new_zeros(l - 1), x.reshape(-1)])
    return flat.as_strided((t, s + l - 1), (s, 1))


def conv1d_direct_plain(x: torch.Tensor, ir: torch.Tensor,
                        edge_mode: str = "clamp") -> torch.Tensor:
    """x (T, S), ir (T, L) -> (T, S): a loop over taps in order."""
    _, s = x.shape
    l = ir.shape[1]
    xp = padded_window(x, l, edge_mode)
    acc = torch.zeros_like(x)
    for k in range(l):
        acc = acc + ir[:, k:k + 1] * xp[:, l - 1 - k:l - 1 - k + s]
    return acc


def _check(x: torch.Tensor, ir: torch.Tensor, edge_mode: str) -> torch.device:
    if edge_mode not in EDGE_MODES:
        raise ValueError(f"conv1d_direct: invalid edge mode {edge_mode!r}")
    for label, t in (("x", x), ("ir", ir)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv1d_direct: {label} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] == 0:
            raise ValueError(f"conv1d_direct: {label} must be 2-D and "
                             f"non-empty, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"conv1d_direct: {label} must be contiguous")
    if ir.shape[0] != x.shape[0]:
        raise ValueError(f"conv1d_direct: {ir.shape[0]} IRs for "
                         f"{x.shape[0]} tracks")
    if ir.device != x.device:
        raise ValueError(f"conv1d_direct: ir on {ir.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv1d_direct: no kernel for {x.device}")
    return x.device


def conv1d_direct(x: torch.Tensor, ir: torch.Tensor,
                  edge_mode: str = "clamp") -> torch.Tensor:
    """Direct per-track FIR, the contract of the JAX ``conv1d_direct``
    (with the golden's bleed): x (T, S), ir (T, L) -> (T, S). The kernel
    runs through ``torch.ops.gpuab.conv1d_direct_launch``
    (``ops/gpuab.py``)."""
    dev = _check(x, ir, edge_mode)
    if not gpuab.use_op(dev):
        return conv1d_direct_plain(x, ir, edge_mode)
    return gpuab.call("conv1d_direct_launch", x, ir, edge_mode == "bleed",
                      counts=KERNEL_LAUNCHES, key="conv1d")


def precompute_ir_spectra(ir: torch.Tensor, fft_size: int) -> torch.Tensor:
    """IR spectra for fast convolution: complex64 (T, fft_size//2 + 1)
    (precomputeImpulseResponseFFTs, cuda/bench_conv1d_accel.cu:254-304)."""
    return torch.fft.rfft(ir, n=fft_size, dim=-1)


def conv1d_fft(x: torch.Tensor, ir_spec: torch.Tensor, fft_size: int,
               out_len: int) -> torch.Tensor:
    """Fast convolution: irfft(rfft(x) * ir_spec)[:, :out_len].
    x (T, S) real, ir_spec complex64 (T, F); returns float32 (T, out_len)."""
    spec = torch.fft.rfft(x, n=fft_size, dim=-1)
    y = torch.fft.irfft(spec * ir_spec, n=fft_size, dim=-1)
    return y[:, :out_len]
