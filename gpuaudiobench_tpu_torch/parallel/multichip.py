"""Multi-device suite step: the audio pipeline sharded over a mesh.

PyTorch counterpart of ``gpuaudiobench_tpu/parallel/multichip.py``'s
``make_suite_step(impl="pallas")``. Each rank runs ``local_step`` on its
shards, with the collectives of ``collectives.py`` where the JAX program
has ``jax.lax``'s:

* dp: the tracks, sharded; no communication.
* tp: the modal bank's modes, sharded; each rank runs its partial bank
  and a psum over "tp" completes the (32, S/sp) mix. The cascade's
  stages are pipelined over "tp" too, GPipe style, with a ppermute
  handoff between stages.
* sp: the samples of the FIR, sharded, with each shard's IR tail
  shipped to its right neighbour (a ppermute halo).

The recurrences run the port's kernels: the entry biquad and every
pipeline stage ``ops/iir.py:iir_biquad`` from a zero state, the partial
bank ``ops/modal.py:modal_bank`` in its rotation form; on CPU tensors
the wrappers run their plain twins. The FIR is ``F.conv1d`` with one
group a track, in full FP32: the JAX program's FIR is XLA's convolution
at ``Precision.HIGHEST``, outside any Pallas kernel, so a library call
stands for it here. On a CUDA device the caller refuses TF32
convolutions (``check_fp32_convolutions``).

The GPipe loop hands its stage output on after every step but the last:
the JAX program's last handoff is never read and XLA drops it, so the
port does not issue it either.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpuaudiobench_tpu_torch.ops.iir import iir_biquad
from gpuaudiobench_tpu_torch.ops.modal import modal_bank
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel.mesh import Mesh
from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients

MIX_TRACKS = 32  # the partial bank folds onto 32 mix tracks


def check_fp32_convolutions(name: str = "") -> None:
    """Raises when float32 convolutions may run in TF32 (cuDNN's default):
    the suite's FIR stands for the JAX package's ``Precision.HIGHEST``
    convolution and runs in full FP32."""
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            f"{name or 'this benchmark'}: cuDNN float32 convolutions are set "
            "to TF32 (torch.backends.cudnn.allow_tf32); its FIR runs in full "
            "FP32")


def biquad(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """DF-II biquad over (T, S) from zero state (no communication)."""
    zero = torch.zeros((x.shape[0], 2), dtype=x.dtype, device=x.device)
    y, _ = iir_biquad(x.contiguous(), coeffs, zero)
    return y


def local_conv(x_with_halo: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Causal FIR of (T, halo+S_local) against the shared IR (L,), the
    valid part: (T, S_local)."""
    t, l = x_with_halo.shape[0], ir.shape[0]
    w = ir.flip(0).reshape(1, 1, l).expand(t, 1, l).contiguous()
    return F.conv1d(x_with_halo[None], w, groups=t)[0]


def make_suite_step(mesh: Mesh, n_micro: int = 2):
    """The calling rank's step:
    fn(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs) -> (T/dp, S/sp)

    on its shards: x (T/dp, S/sp), the mode tables (M/tp,), ir (L,) and
    stage_coeffs (K, 5) whole (one stage per tp rank)."""
    tp = mesh.axis_size("tp")
    sp = mesh.axis_size("sp")

    def local_step(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs):
        t_local, s_local = x.shape
        l = ir.shape[0]

        # dp stage: gain + IIR on the local tracks; the recurrence needs
        # the whole time axis, so gather the sp shards, run it, keep ours.
        x_full = col.all_gather(x, mesh, "sp", dim=1)  # (T/dp, S)
        y_full = biquad(2.0 * x_full, stage_coeffs[0])

        # sp stage: the FIR with a halo exchange on the sample axis.
        sp_idx = mesh.axis_index("sp")
        y_local = y_full[:, sp_idx * s_local:(sp_idx + 1) * s_local]
        halo = col.ppermute(y_local[:, -(l - 1):] if l > 1
                            else y_local[:, :0], mesh, "sp", col.ring(sp))
        if sp_idx == 0:
            halo = torch.zeros_like(halo)
        conv_out = local_conv(torch.cat([halo, y_local], dim=1), ir)

        # tp stage: the partial modal bank + psum over "tp". Each sp shard
        # owns samples [sp_idx * s_local, ...), so the phasors are first
        # rotated to its start, one sample at a time as the JAX loop does.
        for _ in range(sp_idx * s_local):
            s_re, s_im = (s_re * cos_w - s_im * sin_w,
                          s_re * sin_w + s_im * cos_w)
        mix_local, _, _ = modal_bank(amp, cos_w, sin_w, s_re, s_im, s_local,
                                     MIX_TRACKS, algorithm="rotation")
        mix = col.psum(mix_local, mesh, "tp")  # (32, S/sp)

        # mix into tracks by global track index % 32
        dp_idx = mesh.axis_index("dp")
        g_track = dp_idx * t_local + torch.arange(t_local, device=x.device)
        mixed = conv_out + mix[g_track % MIX_TRACKS, :]

        # pp stage: the cascade pipelined over "tp", one stage a rank, on
        # the whole sample axis.
        mixed_full = col.all_gather(mixed, mesh, "sp", dim=1)
        s_full = mixed_full.shape[1]
        k_idx = mesh.axis_index("tp")
        micro_t = t_local // n_micro
        micro = mixed_full.reshape(n_micro, micro_t, s_full)
        buf = torch.zeros((micro_t, s_full), dtype=mixed.dtype,
                          device=x.device)
        out = torch.zeros_like(micro)
        n_steps = n_micro + tp - 1
        for step_i in range(n_steps):
            if k_idx == 0:
                cur = (micro[step_i] if step_i < n_micro
                       else torch.zeros_like(buf))
            else:
                cur = buf
            cur = biquad(cur, stage_coeffs[k_idx])
            done_i = step_i - (tp - 1)
            if done_i >= 0 and k_idx == tp - 1:
                out[done_i] = cur
            if step_i < n_steps - 1:  # the last handoff is never read
                buf = col.ppermute(cur, mesh, "tp", col.ring(tp))
        out = col.psum(out, mesh, "tp")  # only the last rank contributed
        out = out.reshape(t_local, s_full)
        return out[:, sp_idx * s_local:(sp_idx + 1) * s_local].contiguous()

    return local_step


def suite_step_example_args(
    shape: Tuple[int, int, int],
    tracks: int = 16,
    samples: int = 64,
    modes: int = 128,
    ir_len: int = 9,
    seed: int = 42,
) -> Tuple[np.ndarray, ...]:
    """Mesh-compatible inputs, whole, as host arrays (the JAX function's,
    before its ``device_put``): x (T, S), amp, cos_w, sin_w, s_re, s_im
    (M,), ir (L,), coeffs (tp, 5)."""
    dp, tp, sp = shape
    tracks = max(tracks, 2 * dp * 2)  # >= 2 microbatches of >=1 track per shard
    tracks -= tracks % (dp * 2)
    samples = samples - samples % sp or sp
    modes = modes - modes % (tp * 32) or tp * 32

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, samples), dtype=np.float32) * 2 - 1).astype(np.float32)
    amp = g.random(modes, dtype=np.float32)
    freq = g.random(modes, dtype=np.float32) * 0.45
    w = 2 * np.pi * freq
    cos_w = np.cos(w).astype(np.float32)
    sin_w = np.sin(w).astype(np.float32)
    s_re = (g.random(modes, dtype=np.float32) * 2 - 1).astype(np.float32)
    s_im = (g.random(modes, dtype=np.float32) * 2 - 1).astype(np.float32)
    ir = np.zeros(ir_len, np.float32)
    ir[0] = 1.0
    ir[ir_len // 2] = 0.5
    n_stages = tp
    coeffs = np.stack(
        [
            np.array(
                biquad_lowpass_coefficients(0.05 + 0.04 * k), np.float32
            )
            for k in range(max(n_stages, 1))
        ]
    )
    return x, amp, cos_w, sin_w, s_re, s_im, ir, coeffs


# How each input of the step is sharded: the mesh axis of each dimension.
ARG_DIMS = (("dp", "sp"), ("tp",), ("tp",), ("tp",), ("tp",), ("tp",),
            (None,), (None, None))
OUT_DIMS = ("dp", "sp")


def shard(host: np.ndarray, mesh: Mesh, dims, device: torch.device
          ) -> torch.Tensor:
    """The calling rank's shard of a whole host array, on ``device``."""
    index = []
    for size, axis in zip(host.shape, dims):
        if axis is None:
            index.append(slice(None))
            continue
        n = size // mesh.axis_size(axis)
        i = mesh.axis_index(axis)
        index.append(slice(i * n, (i + 1) * n))
    return torch.from_numpy(np.ascontiguousarray(host[tuple(index)])).to(
        device, copy=True)


def shard_args(host_args, mesh: Mesh, device: torch.device):
    """The calling rank's shards of ``suite_step_example_args``."""
    return tuple(shard(a, mesh, d, device) for a, d in zip(host_args, ARG_DIMS))
