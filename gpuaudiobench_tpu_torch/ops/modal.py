"""Modal filter bank: phasor-rotation sinusoid bank.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/modal.py`` and of the two
contracts of ``gpuaudiobench_tpu/ops/modal_pallas.py``. Per mode m:

  each sample: state *= e^{i*w}  (rotate first)
               out[m % T_out, s] += amp * Re(state)

Two plain PyTorch twins keep the f32 op order of ``modal_bank_xla``:

* ``modal_bank_plain``        -> (out (T_out, S), re', im')
* ``modal_folded_step_plain`` -> (out (S, T_out), re', im') on
  amp-prefolded states.

Two wrappers of the hand-written CUDA kernel (``csrc/modal_bank.cu``)
keep the Pallas contracts:

* ``modal_bank`` -> (out (T_out, S), re, im): one block per round trip;
  the input states come back unchanged (Metal parity,
  ``modal_pallas.py:240-242``).
* ``modal_folded_step`` -> (out (S, T_out), re', im'): the streaming
  step on amp-prefolded states, returning the rotated states.

A wrapper runs the plain twin only because its tensors lie on the CPU.
On a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# Launches of the CUDA kernel by the two wrappers, counted where they
# launch it (chip_smoke.py reads it to prove the main path used it).
KERNEL_LAUNCHES = 0

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def modal_bank_plain(amp, cos_w, sin_w, state_re, state_im,
                     buffer_size: int, output_tracks: int) -> Tensors:
    """All mode params are (M,) float32 with M % output_tracks == 0.
    Returns (out (output_tracks, S) track-major, state_re', state_im')."""
    groups = amp.shape[0] // output_tracks
    re, im = state_re, state_im
    out = torch.empty((buffer_size, output_tracks), dtype=amp.dtype,
                      device=amp.device)
    for n in range(buffer_size):
        new_re = re * cos_w - im * sin_w
        new_im = re * sin_w + im * cos_w
        re, im = new_re, new_im
        out[n] = (amp * new_re).reshape(groups, output_tracks).sum(dim=0)
    return out.t(), re, im


def modal_folded_step_plain(cos_w, sin_w, re_f, im_f,
                            buffer_size: int, output_tracks: int) -> Tensors:
    """One streaming block on amp-prefolded states: returns
    (out (S, output_tracks) sample-major, re', im')."""
    groups = cos_w.shape[0] // output_tracks
    re, im = re_f, im_f
    out = torch.empty((buffer_size, output_tracks), dtype=cos_w.dtype,
                      device=cos_w.device)
    for n in range(buffer_size):
        new_re = re * cos_w - im * sin_w
        new_im = re * sin_w + im * cos_w
        re, im = new_re, new_im
        out[n] = new_re.reshape(groups, output_tracks).sum(dim=0)
    return out, re, im


def _check(tensors, buffer_size: int, output_tracks: int) -> torch.device:
    m = tensors[0].shape[0]
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"modal bank needs float32, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != m:
            raise ValueError(
                f"modal bank needs equal-length 1-D tables, got "
                f"{tuple(t.shape)} beside ({m},)")
        if not t.is_contiguous():
            raise ValueError("modal bank needs contiguous tables")
        if t.device != dev:
            raise ValueError(
                f"modal bank tables on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"modal bank has no kernel for {dev}")
    if m == 0 or buffer_size <= 0 or output_tracks <= 0:
        raise ValueError("modal bank needs M, S and T_out > 0")
    if m % output_tracks != 0:
        raise ValueError(
            f"mode count {m} is not a multiple of output_tracks "
            f"{output_tracks}")
    if dev.type == "cuda" and 32 % output_tracks != 0:
        # The kernel maps lane l onto track l mod T_out; see ROADMAP.md.
        raise ValueError(
            f"the CUDA modal kernel needs output_tracks dividing 32, got "
            f"{output_tracks} (not yet ported; see ROADMAP.md)")
    return dev


def _lib() -> ctypes.CDLL:
    from gpuaudiobench_tpu_torch.utils.build import load

    lib = load("modal_bank")
    if lib.modal_bank_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.modal_bank_num_blocks.argtypes = [i]
        lib.modal_bank_num_blocks.restype = i
        lib.modal_bank_launch.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.modal_bank_launch.restype = i
    return lib


def _launch(cos_w, sin_w, amp: Optional[torch.Tensor], re, im,
            buffer_size: int, output_tracks: int, keep_states: bool,
            track_major: bool):
    """Launch the kernel on the current stream; returns (out, re', im')
    with re', im' None unless ``keep_states``."""
    global KERNEL_LAUNCHES
    lib = _lib()
    m = cos_w.shape[0]
    dev = cos_w.device
    n_blocks = lib.modal_bank_num_blocks(m)
    partials = torch.empty((n_blocks, buffer_size, output_tracks),
                           dtype=torch.float32, device=dev)
    shape = ((output_tracks, buffer_size) if track_major
             else (buffer_size, output_tracks))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    re_o = torch.empty_like(re) if keep_states else None
    im_o = torch.empty_like(im) if keep_states else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.modal_bank_launch(
            ptr(cos_w), ptr(sin_w), ptr(amp), ptr(re), ptr(im),
            ptr(re_o), ptr(im_o), partials.data_ptr(), out.data_ptr(),
            m, buffer_size, output_tracks, int(track_major), stream)
    if err != 0:
        raise RuntimeError(f"modal_bank_launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out, re_o, im_o


def modal_bank(amp, cos_w, sin_w, state_re, state_im,
               buffer_size: int, output_tracks: int) -> Tensors:
    """Same contract as ``modal_bank_pallas``: (out (T_out, S), re, im)
    with the input states returned unchanged."""
    dev = _check((amp, cos_w, sin_w, state_re, state_im),
                 buffer_size, output_tracks)
    if dev.type == "cpu":
        out, _, _ = modal_bank_plain(amp, cos_w, sin_w, state_re, state_im,
                                     buffer_size, output_tracks)
        return out, state_re, state_im
    out, _, _ = _launch(cos_w, sin_w, amp, state_re, state_im, buffer_size,
                        output_tracks, keep_states=False, track_major=True)
    return out, state_re, state_im


def modal_folded_step(cos_w, sin_w, re_f, im_f,
                      buffer_size: int, output_tracks: int) -> Tensors:
    """Same contract as ``modal_pallas.modal_folded_step``: one block on
    amp-prefolded states, (out (S, T_out), re', im') with the rotated
    states, so blocks chain."""
    dev = _check((cos_w, sin_w, re_f, im_f), buffer_size, output_tracks)
    if dev.type == "cpu":
        return modal_folded_step_plain(cos_w, sin_w, re_f, im_f,
                                       buffer_size, output_tracks)
    return _launch(cos_w, sin_w, None, re_f, im_f, buffer_size,
                   output_tracks, keep_states=True, track_major=False)
