"""Random memory access (granular synthesis): per-track windows gathered
from a large sample pool into an interleaved output.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/rndmem.py`` and
``ops/rndmem_pallas.py``: for each track t, S contiguous samples from its
playhead, written interleaved, out[i, t] = pool[start(t) + i], out (S, T)
(flat layout T*i + t, as bench_rndmem.cu:18 writes it).

Each start follows ``jax.lax.dynamic_slice``, as in the JAX
``rndmem_gather``: a negative playhead counts from the end of the pool
(P is added once), and the start is then clamped to [0, P - S]. The
Pallas kernel does not clamp, and needs ``POOL_PAD`` samples of tail
slack in the pool instead. The port's kernel and its plain twin both
clamp, so the pool carries no padding.

* ``rndmem_gather(pool, playheads, samples)`` wraps the hand-written CUDA
  kernel (``csrc/rndmem.cu``), which replaces the Pallas
  ``_rndmem_kernel``, through the ``torch.ops.gpuab.rndmem_gather_launch``
  operator (``ops/gpuab.py``), which an exported program calls too.
* ``rndmem_gather_plain`` is its twin: one advanced-indexing gather of
  the clamped windows, transposed.

``rndmem_gather`` runs the twin only because its tensors lie on the CPU
(and calls the operator, whose CPU implementation is the twin, while a
CPU program is traced). On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

from typing import Dict

import torch

from gpuaudiobench_tpu_torch.ops import gpuab

# Launches of the CUDA kernel, counted by the wrapper where it launches
# it (chip_smoke.py reads it to prove the main path used it).
KERNEL_LAUNCHES: Dict[str, int] = {"rndmem_gather": 0}


def clamped_starts(playheads: torch.Tensor, pool_len: int,
                   samples: int) -> torch.Tensor:
    """The window starts the gather reads, in int64: each playhead, plus
    pool_len when negative, clamped to [0, pool_len - samples]."""
    ph = playheads.to(torch.int64)
    ph = torch.where(ph < 0, ph + pool_len, ph)
    return ph.clamp(0, pool_len - samples)


def rndmem_gather_plain(pool: torch.Tensor, playheads: torch.Tensor,
                        samples: int) -> torch.Tensor:
    """pool (P,), playheads (T,) int32 -> (samples, T)."""
    start = clamped_starts(playheads, pool.shape[0], samples)
    idx = start[:, None] + torch.arange(samples, device=pool.device)
    return pool[idx].t().contiguous()


def _check(pool: torch.Tensor, playheads: torch.Tensor,
           samples: int) -> torch.device:
    if pool.dtype != torch.float32:
        raise TypeError(f"rndmem_gather: pool must be float32, got {pool.dtype}")
    if playheads.dtype != torch.int32:
        raise TypeError("rndmem_gather: playheads must be int32, got "
                        f"{playheads.dtype}")
    for label, t in (("pool", pool), ("playheads", playheads)):
        if t.dim() != 1 or t.shape[0] == 0:
            raise ValueError(f"rndmem_gather: {label} must be 1-D and "
                             f"non-empty, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"rndmem_gather: {label} must be contiguous")
    if not 0 < samples <= pool.shape[0]:
        raise ValueError(f"rndmem_gather: {samples} samples from a pool of "
                         f"{pool.shape[0]}")
    if playheads.device != pool.device:
        raise ValueError(f"rndmem_gather: playheads on {playheads.device}, "
                         f"pool on {pool.device}")
    if pool.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rndmem_gather: no kernel for {pool.device}")
    return pool.device


def rndmem_gather(pool: torch.Tensor, playheads: torch.Tensor,
                  samples: int) -> torch.Tensor:
    """The contract of the JAX ``rndmem_gather``: pool (P,) float32,
    playheads (T,) int32 -> (samples, T) interleaved."""
    dev = _check(pool, playheads, samples)
    if not gpuab.use_op(dev):
        return rndmem_gather_plain(pool, playheads, samples)
    return gpuab.call("rndmem_gather_launch", pool, playheads, samples,
                      counts=KERNEL_LAUNCHES, key="rndmem_gather")
