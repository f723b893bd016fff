"""Modal filter bank: phasor-rotation sinusoid bank, and its
Gordon-Smith resonator form.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/modal.py`` and of the
contracts of ``gpuaudiobench_tpu/ops/modal_pallas.py``. Per mode m:

  each sample: state *= e^{i*w}  (rotate first)
               out[m % T_out, s] += amp * Re(state)

Any T_out that divides M is taken, on the CPU and on the card.

Plain PyTorch twins keep the f32 op order of the JAX functions:

* ``modal_bank_plain``        -> (out (T_out, S), re', im') for the
  rotation (``modal_bank_xla``); for ``algorithm="res"``, the resonator
  block with the input states returned unchanged.
* ``modal_folded_step_plain`` -> (out (S, T_out), re', im') on
  amp-prefolded states.
* ``modal_res_step_plain``    -> (out (S, T_out), y', q'): the resonator
  block, q' = q - eps*y, y' = y + eps*q', y' folded.

Wrappers of the hand-written CUDA kernels (``csrc/modal_bank.cu``) keep
the Pallas contracts:

* ``modal_bank`` -> (out (T_out, S), re, im): one block per round trip;
  the input states come back unchanged (Metal parity,
  ``modal_pallas.py:240-242``). ``algorithm`` "rotation" (the default)
  or "res" (``res_init``, then the resonator kernel).
* ``modal_folded_step`` -> (out (S, T_out), re', im'): the streaming
  step on amp-prefolded states, returning the rotated states.
* ``modal_res_step`` -> (out (S, T_out), y', q'): the resonator's
  streaming step (replaces ``_modal_kernel_res``).

A wrapper runs the plain twin only because its tensors lie on the CPU.
On a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

# Launches of each kernel, by name, counted where the wrappers launch
# them: "modal_bank" the rotation (modal_bank, modal_folded_step),
# "modal_res" the resonator (modal_bank with algorithm "res",
# modal_res_step). chip_smoke.py reads them to prove the main paths used
# the kernels.
KERNEL_LAUNCHES: Dict[str, int] = {"modal_bank": 0, "modal_res": 0}
ALGORITHMS = ("rotation", "res")

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def modal_bank_plain(amp, cos_w, sin_w, state_re, state_im,
                     buffer_size: int, output_tracks: int,
                     algorithm: str = "rotation") -> Tensors:
    """All mode params are (M,) float32 with M % output_tracks == 0.
    Returns (out (output_tracks, S) track-major, state_re', state_im');
    for ``algorithm="res"`` the states are the inputs, unchanged."""
    if algorithm == "res":
        eps, y0, q0 = res_init(cos_w, sin_w, amp * state_re, amp * state_im)
        out, _, _ = modal_res_step_plain(eps, y0, q0, buffer_size,
                                         output_tracks)
        return out.t(), state_re, state_im
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


def res_init(cos_w, sin_w, re_f, im_f) -> Tensors:
    """Phasor -> Gordon-Smith state for amp-prefolded (re, im), in the f32
    op order of ``modal_pallas.res_init``: (eps, y0, q0) with h = w/2,
    eps = 2 sin h, y0 = re, q0 = sin(h)*re - cos(h)*im. The half angle
    comes through sin (sin h = sin w / (2 cos h), cos h = sqrt((1+c)/2)),
    not 1 - cos, which cancels for low-frequency modes."""
    ch = torch.sqrt((1.0 + cos_w) * 0.5)
    sh = sin_w / (2.0 * ch)
    eps = 2.0 * sh
    return eps, re_f, sh * re_f - ch * im_f


def modal_res_step_plain(eps, y, q, buffer_size: int,
                         output_tracks: int) -> Tensors:
    """One resonator block: (out (S, output_tracks) sample-major, y', q')."""
    groups = eps.shape[0] // output_tracks
    out = torch.empty((buffer_size, output_tracks), dtype=eps.dtype,
                      device=eps.device)
    for n in range(buffer_size):
        q = q - eps * y
        y = y + eps * q
        out[n] = y.reshape(groups, output_tracks).sum(dim=0)
    return out, y, q


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
    return dev


def _lib() -> ctypes.CDLL:
    from gpuaudiobench_tpu_torch.utils.build import load

    lib = load("modal_bank")
    if lib.modal_bank_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.modal_bank_num_blocks.argtypes = [i, i]
        lib.modal_bank_num_blocks.restype = i
        lib.modal_bank_launch.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.modal_bank_launch.restype = i
        lib.modal_res_launch.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.modal_res_launch.restype = i
    return lib


def _launch(algorithm: str, tables, amp: Optional[torch.Tensor], s0, s1,
            buffer_size: int, output_tracks: int, keep_states: bool,
            track_major: bool):
    """Launch the rotation kernel (tables = (cos_w, sin_w), states
    (re, im)) or the resonator kernel (``algorithm="res"``, tables =
    (eps,), states (y, q)) on the current stream; returns (out, s0', s1')
    with s0', s1' None unless ``keep_states``."""
    lib = _lib()
    m = s0.shape[0]
    dev = s0.device
    n_blocks = lib.modal_bank_num_blocks(m, output_tracks)
    partials = torch.empty((n_blocks, buffer_size, output_tracks),
                           dtype=torch.float32, device=dev)
    shape = ((output_tracks, buffer_size) if track_major
             else (buffer_size, output_tracks))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    s0_o = torch.empty_like(s0) if keep_states else None
    s1_o = torch.empty_like(s1) if keep_states else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    res = algorithm == "res"
    fn_name = "modal_res_launch" if res else "modal_bank_launch"
    ins = [ptr(t) for t in tables] + ([] if res else [ptr(amp)])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            *ins, ptr(s0), ptr(s1), ptr(s0_o), ptr(s1_o),
            partials.data_ptr(), out.data_ptr(),
            m, buffer_size, output_tracks, int(track_major), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    KERNEL_LAUNCHES["modal_res" if res else "modal_bank"] += 1
    return out, s0_o, s1_o


def modal_bank(amp, cos_w, sin_w, state_re, state_im,
               buffer_size: int, output_tracks: int,
               algorithm: str = "rotation") -> Tensors:
    """Same contract as ``modal_bank_pallas``: (out (T_out, S), re, im)
    with the input states returned unchanged; ``algorithm`` "rotation"
    or "res" (the resonator from ``res_init`` of the amp-prefolded
    states)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"modal bank: invalid algorithm {algorithm!r}")
    dev = _check((amp, cos_w, sin_w, state_re, state_im),
                 buffer_size, output_tracks)
    if dev.type == "cpu":
        out, _, _ = modal_bank_plain(amp, cos_w, sin_w, state_re, state_im,
                                     buffer_size, output_tracks, algorithm)
        return out, state_re, state_im
    if algorithm == "res":
        eps, y0, q0 = res_init(cos_w, sin_w, amp * state_re, amp * state_im)
        out, _, _ = _launch("res", (eps,), None, y0, q0, buffer_size,
                            output_tracks, keep_states=False,
                            track_major=True)
    else:
        out, _, _ = _launch("rotation", (cos_w, sin_w), amp, state_re,
                            state_im, buffer_size, output_tracks,
                            keep_states=False, track_major=True)
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
    return _launch("rotation", (cos_w, sin_w), None, re_f, im_f,
                   buffer_size, output_tracks, keep_states=True,
                   track_major=False)


def modal_res_step(eps, y, q, buffer_size: int,
                   output_tracks: int) -> Tensors:
    """Same contract as ``modal_pallas.modal_res_step``: one resonator
    block, (out (S, T_out), y', q') with the advanced states, so blocks
    chain."""
    dev = _check((eps, y, q), buffer_size, output_tracks)
    if dev.type == "cpu":
        return modal_res_step_plain(eps, y, q, buffer_size, output_tracks)
    return _launch("res", (eps,), None, y, q, buffer_size, output_tracks,
                   keep_states=True, track_major=False)
