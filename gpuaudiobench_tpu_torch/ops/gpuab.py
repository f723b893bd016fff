"""The ``gpuab`` operators: the hand-written kernels as PyTorch ops.

``csrc/torch_ops.cc`` registers one operator for each C entry of a
kernel of the package, 15 in all (``OPS``); every wrapper in ``ops/*.py``
launches its kernel through one. Each allocates its outputs and scratch
and returns them, but ``dwg_block_launch``, which updates its rails in
place (``Tensor(a!)``), as its wrapper always has:

* ``modal_bank_launch`` and ``modal_res_launch`` (``csrc/modal_bank.cu``,
  the rotation and the resonator): (out, states'), out (T_out, S) with
  ``track_major`` else (S, T_out), the states empty (0,) tensors unless
  ``keep_states``.
* ``iir_biquad_launch``, ``iir_blockstate_launch``, ``iir_cascade_launch``
  and ``iir_cascade_chain_launch`` (``csrc/iir.cu``, the scan, the
  block-state kernel, the systolic and the chain cascade): (y, states').
* ``conv1d_direct_launch`` (``csrc/conv1d.cu``): out.
* ``rndmem_gather_launch`` (``csrc/rndmem.cu``): out (samples, T).
* ``dwg_block_launch`` (``csrc/dwg.cu``): the mono out (S,), fwd and bwd
  written in place.
* ``fdtd_div_cluster_launch`` and ``fdtd_div_planes_launch``
  (``csrc/fdtd3d.cu``, the divergence form's two routes): (out, p',
  div') from the source row, the schedule's ranges as ``int[] starts``;
  ``fdtd_field_planes_launch``, the field form's plane kernel: (out, p',
  vx', vy', vz'), with the per-track receivers' plane buckets as the
  tensors ``rcv_cells``, ``rcv_order`` and ``rcv_starts``, which
  ``fdtd_receiver_buckets`` (the bucketing kernel) computes from the
  receivers on the device: (cells, order, starts).
* ``fma_chain_launch`` and ``fma_vmem_launch``
  (``csrc/speedoflight.cu``): the chain's result.

The schedule each takes is computed by its ops module, as before the ops
existed; an export bakes it into the program as constants. ``load``
builds the library (``utils/native.py:build_ops``) and loads it once a
process, then registers each operator's shapes (``register_fake``, for
tracing) and its plain twin as its CPU implementation, so that a CPU
program can be traced, exported and run in a Python process. The twins
exist only in Python: a process without Python that loads the library
(``csrc/native_runner.cc``) has no CPU implementation of the operators,
and a CUDA tensor reaches only the kernel.

A wrapper in ``ops/*.py`` calls an operator on a CUDA tensor, and on a
CPU tensor only while a program is being traced (``torch.export``); an
eager call on a CPU tensor runs the twin directly. It calls through
``call``, which runs the operator inside a ``gpuab.op`` span
(``harness/profiler.py``) and counts the launch in the wrapper's
``KERNEL_LAUNCHES`` unless the call is being traced.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict

import torch

from gpuaudiobench_tpu_torch.harness.graph import count_launch
from gpuaudiobench_tpu_torch.harness.profiler import span

OPS = ("modal_bank_launch", "modal_res_launch", "iir_biquad_launch",
       "iir_blockstate_launch", "iir_cascade_launch",
       "iir_cascade_chain_launch", "conv1d_direct_launch",
       "rndmem_gather_launch", "dwg_block_launch", "fdtd_div_cluster_launch",
       "fdtd_div_planes_launch", "fdtd_field_planes_launch",
       "fma_chain_launch", "fma_vmem_launch", "fdtd_receiver_buckets")

_LOCK = threading.Lock()


def tracing() -> bool:
    """Whether a program is being traced (``torch.export``, ``torch.compile``)."""
    return torch.compiler.is_compiling()


def use_op(device: torch.device) -> bool:
    """Whether a wrapper calls its operator for a tensor on ``device``: on
    CUDA always, on the CPU while tracing."""
    return device.type == "cuda" or tracing()


def call(name: str, *args, counts: Dict[str, int], key: str):
    """``torch.ops.gpuab.<name>(*args)`` inside a ``gpuab.op`` span, and
    one launch of ``key`` counted in ``counts``
    (``harness.graph.count_launch``) unless the call is being traced and
    so launched nothing."""
    op = getattr(load(), name)
    with span("gpuab.op"):
        out = op(*args)
    if not tracing():
        count_launch(counts, key)
    return out


@functools.lru_cache(maxsize=None)
def _loaded() -> str:
    from gpuaudiobench_tpu_torch.utils import native

    path = str(native.build_ops())
    torch.ops.load_library(path)
    _register()
    return path


def load():
    """``torch.ops.gpuab``, its library built and loaded and its fake and
    CPU implementations registered, once a process. Raises
    ``RuntimeError`` where the library cannot be built or loaded (there is
    no other route to the kernels)."""
    with _LOCK:
        _loaded()
    return torch.ops.gpuab


def library_path() -> str:
    """The path of the loaded library (``load`` first)."""
    with _LOCK:
        return _loaded()


def _register() -> None:
    from gpuaudiobench_tpu_torch.ops import (
        conv,
        dwg,
        fdtd3d,
        iir,
        modal,
        rndmem,
        speedoflight,
    )

    def fake_modal(cos_w, sin_w, amp, re, im, buffer_size, output_tracks,
                   track_major, keep_states, *_schedule):
        shape = ((output_tracks, buffer_size) if track_major
                 else (buffer_size, output_tracks))
        states = ((re.new_empty(re.shape), im.new_empty(im.shape))
                  if keep_states else (re.new_empty(0), im.new_empty(0)))
        return (re.new_empty(shape), *states)

    def cpu_modal(cos_w, sin_w, amp, re, im, buffer_size, output_tracks,
                  track_major, keep_states, *_schedule):
        if amp is not None:
            out, re2, im2 = modal.modal_bank_plain(
                amp, cos_w, sin_w, re, im, buffer_size, output_tracks)
            out = out.t()
        else:
            out, re2, im2 = modal.modal_folded_step_plain(
                cos_w, sin_w, re, im, buffer_size, output_tracks)
        out = (out.t() if track_major else out).contiguous()
        if not keep_states:
            re2, im2 = re.new_empty(0), im.new_empty(0)
        return out, re2, im2

    def fake_res(eps, y, q, buffer_size, output_tracks, track_major,
                 keep_states, *_schedule):
        return fake_modal(None, None, None, y, q, buffer_size,
                          output_tracks, track_major, keep_states)

    def cpu_res(eps, y, q, buffer_size, output_tracks, track_major,
                keep_states, *_schedule):
        out, y2, q2 = modal.modal_res_step_plain(eps, y, q, buffer_size,
                                                 output_tracks)
        out = out.t().contiguous() if track_major else out
        if not keep_states:
            y2, q2 = y.new_empty(0), q.new_empty(0)
        return out, y2, q2

    def fake_pair(x, coeffs, state, *_schedule):
        return x.new_empty(x.shape), state.new_empty(state.shape)

    def fake_blockstate(x, coeffs, taps, u, state):
        return x.new_empty(x.shape), state.new_empty(state.shape)

    def cpu_blockstate(x, coeffs, taps, u, state):
        return iir.iir_biquad_blockstate_plain(x, coeffs, taps, u, state)

    def cpu_biquad(x, coeffs, state):
        return iir.iir_biquad_plain(x, coeffs, state)

    def cpu_cascade(x, coeffs, states, *_schedule):
        return iir.iir_cascade_plain(x, coeffs, states)

    def fake_conv(x, ir, bleed):
        return x.new_empty(x.shape)

    def cpu_conv(x, ir, bleed):
        return conv.conv1d_direct_plain(x, ir, "bleed" if bleed else "clamp")

    def fake_rndmem(pool, playheads, samples):
        return pool.new_empty((samples, playheads.shape[0]))

    def cpu_rndmem(pool, playheads, samples):
        return rndmem.rndmem_gather_plain(pool, playheads, samples)

    def fake_dwg(x, fwd, bwd, *_rest):
        return x.new_empty(x.shape)

    def cpu_dwg(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp,
                *_schedule):
        return dwg.dwg_block_plain(x, fwd, bwd, lengths, in_taps, out_taps,
                                   gains, refl, damp)[0]

    def fake_fdtd(src, p, div, tracks, *_rest):
        return (p.new_empty((tracks, src.shape[0])), p.new_empty(p.shape),
                div.new_empty(div.shape))

    def cpu_fdtd(src, p, div, tracks, src_cell, rcv_cell, *_rest):
        return fdtd3d.fdtd3d_div_from_source(src, p, div, tracks, src_cell,
                                             rcv_cell)

    def fake_field(src, p, vx, vy, vz, rcv_cells, rcv_order, rcv_starts,
                   tracks, *_rest):
        return (p.new_empty((tracks, src.shape[0])),
                *(f.new_empty(f.shape) for f in (p, vx, vy, vz)))

    def cpu_field(src, p, vx, vy, vz, rcv_cells, rcv_order, rcv_starts,
                  tracks, src_cell, rcv_cell, *_rest):
        return fdtd3d.fdtd3d_field_from_source(src, p, vx, vy, vz, tracks,
                                               src_cell, rcv_cell, rcv_cells)

    def fake_buckets(receivers, n):
        return (receivers.new_empty(receivers.shape),
                receivers.new_empty(receivers.shape),
                receivers.new_empty((n + 1,)))

    def cpu_buckets(receivers, n):
        return fdtd3d.receiver_buckets_plain(receivers, n)

    def fake_fma(x, k, m, c):
        return x.new_empty(x.shape)

    def cpu_fma(x, k, m, c):
        return speedoflight.fma_chain_plain(x, k, m, c)

    for name, fake, cpu in (
            ("modal_bank_launch", fake_modal, cpu_modal),
            ("modal_res_launch", fake_res, cpu_res),
            ("iir_biquad_launch", fake_pair, cpu_biquad),
            ("iir_blockstate_launch", fake_blockstate, cpu_blockstate),
            ("iir_cascade_launch", fake_pair, cpu_cascade),
            ("iir_cascade_chain_launch", fake_pair, cpu_cascade),
            ("conv1d_direct_launch", fake_conv, cpu_conv),
            ("rndmem_gather_launch", fake_rndmem, cpu_rndmem),
            ("dwg_block_launch", fake_dwg, cpu_dwg),
            ("fdtd_div_cluster_launch", fake_fdtd, cpu_fdtd),
            ("fdtd_div_planes_launch", fake_fdtd, cpu_fdtd),
            ("fdtd_field_planes_launch", fake_field, cpu_field),
            ("fma_chain_launch", fake_fma, cpu_fma),
            ("fma_vmem_launch", fake_fma, cpu_fma),
            ("fdtd_receiver_buckets", fake_buckets, cpu_buckets)):
        torch.library.register_fake(f"gpuab::{name}", fake)
        torch.library.impl(f"gpuab::{name}", "CPU", cpu)
