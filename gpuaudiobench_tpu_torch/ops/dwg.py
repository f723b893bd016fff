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

* ``dwg_block`` wraps the hand-written CUDA kernels (``csrc/dwg.cu``),
  which replace the Pallas ``_dwg_kernel``: each closed rail cell pair
  (fwd[g, p], bwd[g, (p + L/2) % L]), p < min(L, S), walks its chain of
  samples p, p + L, ... in one thread, threads laid along the row; the
  out-tap pairs walk in mono blocks that sum the output in a fixed order.
  ``dwg_schedule`` is its launch geometry. It launches them through the
  ``torch.ops.gpuab.dwg_block_launch`` operator (``ops/gpuab.py``), which
  an exported program calls too; the operator writes the rails in place
  (its schema marks them mutated), as the kernel does.
* ``dwg_block_plain`` is its twin: a loop over samples with a gather and
  a scatter on all rows, as the JAX ``dwg_block`` runs it.
* ``dwg_mono_in_order`` is the kernel's mono output in NumPy, summed in
  the kernel's order, so a check can hold the output bit for bit.

Both update the given rails in place and return ``(out (S,), fwd, bwd)``;
a caller that needs the starting rails clones them first. Lengths must lie in [1, Lmax] (the kernel leaves a row outside
that range untouched; the benchmark checks its lengths on the host).

``dwg_block`` runs the twin only because its tensors lie on the CPU (and
calls the operator, whose CPU implementation is the twin, while a CPU
program is traced). On a CUDA tensor it launches the kernel or raises; it
never falls back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from gpuaudiobench_tpu_torch.ops import gpuab

MIX_FACTOR = 0.5  # benchmark_constants.cuh WAVEGUIDE_MIX_FACTOR

# Launches of the CUDA kernel, counted by the wrapper where it launches
# it (chip_smoke.py reads it to prove the main path used it).
KERNEL_LAUNCHES: Dict[str, int] = {"dwg_block": 0}

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

DWG_WARPS = 4  # warps a block of the kernel
DWG_GROUP = 32 * DWG_WARPS  # waveguides a mono group (one block)
DWG_PAIRS = 8  # cell pairs a thread (csrc/dwg.cu kPairs)


@dataclass(frozen=True)
class DWGSchedule:
    """Launch geometry of the DWG kernel for (waveguides, S, Lmax).

    A warp of an update block owns a segment of 32 * ``DWG_PAIRS``
    consecutive cells of one row: lane l holds the pairs p = start + l +
    32 j, j < ``DWG_PAIRS``. ``segments`` segments cover the row's first
    min(Lmax, S) cells. The grid's first ``groups`` blocks are the mono
    groups (128 waveguides each); block ``groups + b`` holds warp tasks
    4 b .. 4 b + 3, task t on row t // segments, segment t % segments
    (``task``). A fold kernel then adds the groups' sums in order. Each
    thread walks its chains to their end, so no depth is needed."""

    segments: int
    groups: int
    update_blocks: int

    @property
    def grid(self) -> int:
        return self.groups + self.update_blocks

    def task(self, block: int, warp: int) -> Tuple[int, int]:
        """(row, first cell) of warp ``warp`` of update block ``block``
        (counted from the first update block)."""
        t = block * DWG_WARPS + warp
        return t // self.segments, t % self.segments * 32 * DWG_PAIRS


@functools.lru_cache(maxsize=64)
def dwg_schedule(guides: int, s: int, lmax: int) -> DWGSchedule:
    """The DWG kernel's schedule."""
    if guides < 1 or s < 1 or lmax < 1:
        raise ValueError(f"dwg_schedule: waveguides {guides}, S {s} and "
                         f"Lmax {lmax} must be >= 1")
    segments = -(-min(lmax, s) // (32 * DWG_PAIRS))
    return DWGSchedule(segments=segments, groups=-(-guides // DWG_GROUP),
                       update_blocks=-(-guides * segments // DWG_WARPS))


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


def dwg_mono_in_order(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl,
                      damp) -> np.ndarray:
    """The kernel's mono output for one block from the starting rails, in
    NumPy float32: each waveguide's out-tap pair walked as the kernel
    walks it, and its contributions summed in the kernel's order. For
    each sample: 32 consecutive waveguides by the xor butterfly (lane 0's
    value: lanes i and i + 16 first, then + 8, + 4, + 2, + 1), the four
    warps of a 128-waveguide group in order, the groups in order from 0.
    Rows with L outside [1, Lmax] contribute nothing."""
    x = np.asarray(x, np.float32)
    lengths = np.asarray(lengths).astype(np.int64)
    in_taps, out_taps = np.asarray(in_taps), np.asarray(out_taps)
    gains, refl, damp = (np.asarray(a, np.float32) for a in (gains, refl, damp))
    guides, lmax = fwd.shape
    s = x.shape[0]
    rows = np.flatnonzero((lengths >= 1) & (lengths <= lmax) & (out_taps >= 0)
                          & (out_taps < np.minimum(lengths, s)))
    length, tap = lengths[rows], out_taps[rows].astype(np.int64)
    fv = np.asarray(fwd, np.float32)[rows, tap]
    bv = np.asarray(bwd, np.float32)[rows, (tap + length // 2) % length]
    inj = tap == in_taps[rows]
    groups = -(-guides // DWG_GROUP)
    contrib = np.zeros((groups * DWG_GROUP, s), np.float32)
    n, live = tap.copy(), np.ones(rows.size, bool)
    half = np.float32(MIX_FACTOR)
    while live.any():
        i = np.flatnonzero(live)
        f = fv[i] * damp[rows[i]]
        b = bv[i] * damp[rows[i]]
        xi = x[n[i]] * gains[rows[i]]
        f = np.where(inj[i], f + xi, f)
        b = np.where(inj[i], b + xi, b)
        fv[i] = b * refl[rows[i]]
        bv[i] = f * refl[rows[i]]
        contrib[rows[i], n[i]] = (f + b) * half
        n[i] += length[i]
        live[i] = n[i] < s
    v = contrib.reshape(groups, DWG_WARPS, 32, s)
    while v.shape[2] > 1:
        h = v.shape[2] // 2
        v = v[:, :, :h] + v[:, :, h:]
    group_sums = v[:, 0, 0]
    for w in range(1, DWG_WARPS):
        group_sums = group_sums + v[:, w, 0]
    out = np.zeros(s, np.float32)
    for k in range(groups):
        out = out + group_sums[k]
    return out


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


def dwg_block(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl,
              damp) -> Triple:
    """One block of G waveguides, rails updated in place: returns (out
    (S,), fwd, bwd)."""
    ints = [("lengths", lengths), ("in_taps", in_taps), ("out_taps", out_taps)]
    floats = [("gains", gains), ("refl", refl), ("damp", damp)]
    dev = _check(x, fwd, bwd, ints, floats)
    if not gpuab.use_op(dev):
        return dwg_block_plain(x, fwd, bwd, lengths, in_taps, out_taps, gains,
                               refl, damp)
    g, lmax = fwd.shape
    sc = dwg_schedule(g, x.shape[0], lmax)
    out = gpuab.call("dwg_block_launch", x, fwd, bwd, lengths, in_taps,
                     out_taps, gains, refl, damp, sc.segments, sc.groups,
                     sc.update_blocks, counts=KERNEL_LAUNCHES, key="dwg_block")
    return out, fwd, bwd
