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
the Pallas contracts; the rotation and the resonator kernel are reached
through the ``torch.ops.gpuab.modal_{bank,res}_launch`` operators
(``ops/gpuab.py``), which an exported program calls too. The library's
ctypes handle (``_lib``) serves only the schedule's queries:
``modal_bank_capacity``, ``modal_bank_warps`` and
``modal_bank_max_modes_per_thread``.

* ``modal_bank`` -> (out (T_out, S), re, im): one block per round trip;
  the input states come back unchanged (Metal parity,
  ``modal_pallas.py:240-242``). ``algorithm`` "rotation" (the default)
  or "res" (``res_init``, then the resonator kernel).
* ``modal_folded_step`` -> (out (S, T_out), re', im'): the streaming
  step on amp-prefolded states, returning the rotated states.
* ``modal_res_step`` -> (out (S, T_out), y', q'): the resonator's
  streaming step (replaces ``_modal_kernel_res``).

A wrapper runs the plain twin only because its tensors lie on the CPU
(and calls the operator, whose CPU implementation is the twin, while a
CPU program is traced). On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from gpuaudiobench_tpu_torch.ops import gpuab

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
    if lib.modal_bank_capacity.argtypes is None:
        i = ctypes.c_int
        for fn in (lib.modal_bank_warps, lib.modal_bank_max_modes_per_thread):
            fn.argtypes = []
            fn.restype = i
        lib.modal_bank_capacity.argtypes = [i]
        lib.modal_bank_capacity.restype = i
    return lib


@dataclass(frozen=True)
class ModalSchedule:
    """The kernel's static schedule of m modes onto a persistent grid.

    The modes lie in rows of ``row_w`` = lcm(32, T_out); a tile is
    ``modes_per_thread`` rows of 32 columns, one warp's share of a pass
    (``tile_modes``). Block b takes the contiguous tiles
    ``block_tiles(b)`` and runs them in ``passes`` passes of ``warps``
    tiles; each pass writes one (S, T_out) partial, so the kernel needs
    ``n_partials`` of them. The order of every sum depends only on the
    schedule."""

    m: int
    t_out: int
    row_w: int
    tiles: int
    grid: int
    passes: int
    warps: int
    modes_per_thread: int

    @property
    def n_partials(self) -> int:
        return self.grid * self.passes

    def block_tiles(self, b: int) -> Tuple[int, int]:
        """Tiles [lo, hi) of block b."""
        return b * self.tiles // self.grid, (b + 1) * self.tiles // self.grid

    def tile_modes(self, tile: int) -> List[List[int]]:
        """Modes of ``tile``: element [lane][k] is lane's mode of row k,
        or -1 past the ragged edge."""
        cols = self.row_w // 32
        base = tile // cols * self.modes_per_thread * self.row_w
        base += 32 * (tile % cols)
        return [[mode if mode < self.m else -1
                 for mode in (base + k * self.row_w + lane
                              for k in range(self.modes_per_thread))]
                for lane in range(32)]


def modal_schedule(m: int, t_out: int, capacity: int, warps: int,
                   max_modes_per_thread: int) -> ModalSchedule:
    """Schedule m modes folded onto t_out tracks for a card on which
    ``capacity`` blocks of ``warps`` rotation warps fit at once. A thread
    holds ``max_modes_per_thread`` modes, halved (rounding down) while the
    tiles would fill less than half of the card's warps, down to one; the
    grid is ``capacity`` blocks, never more than there are tiles, and a
    block takes as many passes as its share of the tiles needs."""
    if m <= 0 or t_out <= 0 or m % t_out or capacity < 1:
        raise ValueError(f"no schedule for M={m}, T_out={t_out}, "
                         f"capacity {capacity}")
    row_w = 32 // math.gcd(32, t_out) * t_out

    def tiles_for(mpt):
        return -(-m // (mpt * row_w)) * (row_w // 32)

    mpt = max_modes_per_thread
    while mpt > 1 and 2 * tiles_for(mpt) < capacity * warps:
        mpt //= 2
    tiles = tiles_for(mpt)
    grid = min(capacity, tiles)
    passes = -(-(-(-tiles // grid)) // warps)
    return ModalSchedule(m, t_out, row_w, tiles, grid, passes, warps, mpt)


# (device index, algorithm, M, T_out) -> the kernel's schedule, worked out
# once: the launch path runs once a block.
_SCHEDULES: Dict[Tuple[int, str, int, int], ModalSchedule] = {}


def _schedule(lib, algorithm: str, m: int, t_out: int,
              dev: torch.device) -> ModalSchedule:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, algorithm, m, t_out)
    sched = _SCHEDULES.get(key)
    if sched is None:
        with torch.cuda.device(dev):
            cap = lib.modal_bank_capacity(int(algorithm == "res"))
        if cap < 0:
            raise RuntimeError(f"modal_bank_capacity failed: CUDA error {-cap}")
        sched = _SCHEDULES[key] = modal_schedule(
            m, t_out, cap, lib.modal_bank_warps(),
            lib.modal_bank_max_modes_per_thread())
    return sched


def _geometry(algorithm: str, m: int, output_tracks: int,
              dev: torch.device) -> Tuple[int, int, int]:
    """(modes a thread, grid, passes) of the kernel's schedule on a CUDA
    device; zeros on the CPU, whose twin (while a CPU program is traced)
    takes no schedule."""
    if dev.type != "cuda":
        return 0, 0, 0
    sched = _schedule(_lib(), algorithm, m, output_tracks, dev)
    return sched.modes_per_thread, sched.grid, sched.passes


def _launch_res(eps, y, q, buffer_size: int, output_tracks: int,
                keep_states: bool, track_major: bool) -> Tensors:
    """The resonator kernel on (eps, y, q) through
    ``torch.ops.gpuab.modal_res_launch``; returns (out, y', q'), the
    states empty (0,) tensors unless ``keep_states``."""
    return gpuab.call(
        "modal_res_launch", eps, y, q, buffer_size, output_tracks,
        track_major, keep_states,
        *_geometry("res", y.shape[0], output_tracks, y.device),
        counts=KERNEL_LAUNCHES, key="modal_res")


def _launch_rotation(cos_w, sin_w, amp: Optional[torch.Tensor], re, im,
                     buffer_size: int, output_tracks: int, keep_states: bool,
                     track_major: bool) -> Tensors:
    """The rotation kernel through ``torch.ops.gpuab.modal_bank_launch``
    (the CPU twin while a CPU program is traced, which takes no
    schedule); returns (out, re', im'), the states empty (0,) tensors
    unless ``keep_states``."""
    return gpuab.call(
        "modal_bank_launch", cos_w, sin_w, amp, re, im, buffer_size,
        output_tracks, track_major, keep_states,
        *_geometry("rotation", re.shape[0], output_tracks, re.device),
        counts=KERNEL_LAUNCHES, key="modal_bank")


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
    if algorithm == "res" and gpuab.use_op(dev):
        eps, y0, q0 = res_init(cos_w, sin_w, amp * state_re, amp * state_im)
        out, _, _ = _launch_res(eps, y0, q0, buffer_size, output_tracks,
                                keep_states=False, track_major=True)
    elif algorithm == "rotation" and gpuab.use_op(dev):
        out, _, _ = _launch_rotation(cos_w, sin_w, amp, state_re, state_im,
                                     buffer_size, output_tracks,
                                     keep_states=False, track_major=True)
    else:
        out, _, _ = modal_bank_plain(amp, cos_w, sin_w, state_re, state_im,
                                     buffer_size, output_tracks, algorithm)
    return out, state_re, state_im


def modal_folded_step(cos_w, sin_w, re_f, im_f,
                      buffer_size: int, output_tracks: int) -> Tensors:
    """Same contract as ``modal_pallas.modal_folded_step``: one block on
    amp-prefolded states, (out (S, T_out), re', im') with the rotated
    states, so blocks chain."""
    dev = _check((cos_w, sin_w, re_f, im_f), buffer_size, output_tracks)
    if not gpuab.use_op(dev):
        return modal_folded_step_plain(cos_w, sin_w, re_f, im_f,
                                       buffer_size, output_tracks)
    return _launch_rotation(cos_w, sin_w, None, re_f, im_f, buffer_size,
                            output_tracks, keep_states=True,
                            track_major=False)


def modal_res_step(eps, y, q, buffer_size: int,
                   output_tracks: int) -> Tensors:
    """Same contract as ``modal_pallas.modal_res_step``: one resonator
    block, (out (S, T_out), y', q') with the advanced states, so blocks
    chain."""
    dev = _check((eps, y, q), buffer_size, output_tracks)
    if not gpuab.use_op(dev):
        return modal_res_step_plain(eps, y, q, buffer_size, output_tracks)
    return _launch_res(eps, y, q, buffer_size, output_tracks,
                       keep_states=True, track_major=False)
