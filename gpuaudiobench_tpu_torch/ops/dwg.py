"""Digital waveguide strings: coupled forward/backward delay-line rails.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/dwg.py`` (and of the
Pallas kernel ``ops/dwg_pallas.py`` and the arc form ``ops/dwg_arc.py``),
with the contract of the JAX ``dwg_block``: a mono input block x (S,),
rails fwd, bwd (G, Lmax) float32, per-waveguide lengths, input and output
taps (G,) int32 and gains, reflections, dampings (G,) float32. Per
waveguide g and sample n (writePos 0):

  cur = n % L ; bpos = (cur + L/2) % L
  f = fwd[g, cur] * damp ; b = bwd[g, bpos] * damp
  if cur == in_tap:  f += x[n]*gain ; b += x[n]*gain
  fwd[g, cur] = b * refl ; bwd[g, bpos] = f * refl
  if cur == out_tap: out[n] += (f + b) * 0.5   (WAVEGUIDE_MIX_FACTOR)

* ``dwg_block`` wraps the hand-written CUDA kernel (``csrc/dwg.cu``),
  which replaces the Pallas ``_dwg_kernel``: one thread per waveguide with
  direct circular indexing, and a deterministic sum of the mono output.
* ``dwg_block_plain`` is its twin: a loop over samples with a gather and
  a scatter on all rows, as the JAX ``dwg_block`` runs it.

Both update the given rails in place and return ``(out (S,), fwd, bwd)``;
a caller that needs the starting rails clones them first. Lengths must lie in [1, Lmax] (the kernel leaves a row outside
that range untouched; the benchmark checks its lengths on the host).

``dwg_block`` runs the twin only because its tensors lie on the CPU. On a
CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

MIX_FACTOR = 0.5  # benchmark_constants.cuh WAVEGUIDE_MIX_FACTOR

# Launches of the CUDA kernel, counted by the wrapper where it launches
# it (chip_smoke.py reads it to prove the main path used it).
KERNEL_LAUNCHES: Dict[str, int] = {"dwg_block": 0}

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def dwg_block_plain(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl,
                    damp) -> Triple:
    """The JAX ``dwg_block``'s sample loop on all rows at once."""
    rows = torch.arange(fwd.shape[0], device=fwd.device)
    lens = lengths.to(torch.int64)
    half = lens // 2
    out = torch.empty_like(x)
    for n in range(x.shape[0]):
        cur = n % lens
        bpos = (cur + half) % lens
        f = fwd[rows, cur] * damp
        b = bwd[rows, bpos] * damp
        inj = torch.where(cur == in_taps, x[n] * gains, 0.0)
        f = f + inj
        b = b + inj
        fwd[rows, cur] = b * refl
        bwd[rows, bpos] = f * refl
        out[n] = torch.where(cur == out_taps, (f + b) * MIX_FACTOR, 0.0).sum()
    return out, fwd, bwd


def _check(x, fwd, bwd, ints, floats) -> torch.device:
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"dwg_block: x must be 1-D and non-empty, got "
                         f"{tuple(x.shape)}")
    if fwd.dim() != 2 or fwd.shape[0] == 0 or fwd.shape[1] == 0:
        raise ValueError(f"dwg_block: rails must be 2-D and non-empty, got "
                         f"{tuple(fwd.shape)}")
    if bwd.shape != fwd.shape:
        raise ValueError(f"dwg_block: fwd {tuple(fwd.shape)} and bwd "
                         f"{tuple(bwd.shape)} differ")
    g = fwd.shape[0]
    for label, t, dtype in ([("x", x, torch.float32), ("fwd", fwd, torch.float32),
                             ("bwd", bwd, torch.float32)]
                            + [(k, v, torch.int32) for k, v in ints]
                            + [(k, v, torch.float32) for k, v in floats]):
        if t.dtype != dtype:
            raise TypeError(f"dwg_block: {label} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dwg_block: {label} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"dwg_block: {label} on {t.device}, x on {x.device}")
        if t.dim() == 1 and label != "x" and t.shape[0] != g:
            raise ValueError(f"dwg_block: {label} has {t.shape[0]} entries "
                             f"for {g} waveguides")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dwg_block: no kernel for {x.device}")
    return x.device


def _lib() -> ctypes.CDLL:
    from gpuaudiobench_tpu_torch.utils.build import load

    lib = load("dwg")
    if lib.dwg_block_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dwg_block_launch.argtypes = [p] * 11 + [i] * 3 + [p]
        lib.dwg_block_launch.restype = i
        lib.dwg_blocks.argtypes = [i]
        lib.dwg_blocks.restype = i
    return lib


def dwg_block(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl,
              damp) -> Triple:
    """One block of G waveguides, rails updated in place: returns (out
    (S,), fwd, bwd)."""
    ints = [("lengths", lengths), ("in_taps", in_taps), ("out_taps", out_taps)]
    floats = [("gains", gains), ("refl", refl), ("damp", damp)]
    dev = _check(x, fwd, bwd, ints, floats)
    if dev.type == "cpu":
        return dwg_block_plain(x, fwd, bwd, lengths, in_taps, out_taps, gains,
                               refl, damp)
    lib = _lib()
    g, lmax = fwd.shape
    s = x.shape[0]
    partials = torch.empty((s, lib.dwg_blocks(g)), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dwg_block_launch(
            x.data_ptr(), fwd.data_ptr(), bwd.data_ptr(), lengths.data_ptr(),
            in_taps.data_ptr(), out_taps.data_ptr(), gains.data_ptr(),
            refl.data_ptr(), damp.data_ptr(), partials.data_ptr(),
            out.data_ptr(), g, lmax, s, stream)
    if err != 0:
        raise RuntimeError(f"dwg_block_launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["dwg_block"] += 1
    return out, fwd, bwd
