"""Device selection and host<->device transfer helpers.

PyTorch counterpart of ``gpuaudiobench_tpu/utils/device.py``. The device
is an explicit ``torch.device`` that callers thread through; nothing here
sets a global default. A request for the GPU never falls back to the
CPU: the CPU is used only when a caller names it.

``to_device`` and ``from_device`` copy through pageable host memory, as
every benchmark's round trip does. ``stage_pinned`` places a host array
in page-locked memory (the reference's cudaMallocHost path,
cuda/bench_utils.cu:101-155) and ``upload`` copies such a buffer to the
card without waiting: the datacopy family and the overlapped-infeed tier
use them. A copy to the device runs inside a ``gpuab.h2d`` span, one to
the host inside a ``gpuab.d2h`` span (``harness/profiler.py``).
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.profiler import span


def device(name: str = "cuda") -> torch.device:
    """``torch.device("cuda:0")`` for ``"cuda"``; ``"cpu"`` only when
    asked for by name. Raises ``RuntimeError`` when CUDA is asked for and
    ``torch.cuda.is_available()`` is False."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def to_device(host_array: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host -> device copy (cudaMemcpy H2D). On the CPU too it is a copy,
    so an in-place update of the tensor never writes the host array."""
    with span("gpuab.h2d"):
        return torch.from_numpy(np.ascontiguousarray(host_array)).to(
            dev, copy=True)


def stage_pinned(host_array: np.ndarray,
                 dev: torch.device) -> Optional[torch.Tensor]:
    """A page-locked CPU tensor holding ``host_array``, the DMA source of
    later uploads to ``dev`` (cudaMallocHost). None on the CPU, which has
    no pinned memory. On a CUDA device a failed pin raises
    ``RuntimeError``: it never returns a pageable buffer in its place."""
    if dev.type != "cuda":
        return None
    src = torch.from_numpy(np.ascontiguousarray(host_array))
    staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    if not staged.is_pinned():
        raise RuntimeError("stage_pinned: the host buffer is not page-locked")
    return staged.copy_(src)


def upload(src, dev: torch.device) -> torch.Tensor:
    """Host -> device copy of a pinned tensor (``stage_pinned``), enqueued
    on the current stream without waiting, or of a numpy array through
    ``to_device``."""
    if isinstance(src, torch.Tensor):
        with span("gpuab.h2d"):
            return src.to(dev, non_blocking=True, copy=True)
    return to_device(src, dev)


def fp32_convolutions(dev: torch.device) -> None:
    """On a CUDA device, float32 convolutions in full FP32 from here on
    (cuDNN's default is TF32; float32 matmuls are full FP32 by default):
    MultiChipSuite's FIR refuses TF32."""
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False


def from_device(t: torch.Tensor) -> np.ndarray:
    """Device -> host copy (cudaMemcpy D2H); waits for the device."""
    with span("gpuab.d2h"):
        return t.cpu().numpy()


def block(dev: torch.device) -> None:
    """Wait until the device has finished all queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nvidia_smi(query: str) -> Optional[str]:
    """The first card's line of ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader``, or None where nvidia-smi is missing or
    fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    return proc.stdout.strip().splitlines()[0]


def nvidia_smi_identity() -> Optional[str]:
    """The card's ``name, power.limit`` line from nvidia-smi, or None."""
    return nvidia_smi("name,power.limit")


def gpu_identity(dev: torch.device) -> Dict[str, Optional[str]]:
    """Name and power limit of the card behind ``dev``:
    ``torch.cuda.get_device_name`` and the power limit from nvidia-smi's
    ``name, power.limit`` line. On the CPU: "cpu" and None."""
    if dev.type != "cuda":
        return {"device_name": "cpu", "power_limit": None}
    line = nvidia_smi_identity()
    return {
        "device_name": torch.cuda.get_device_name(dev),
        "power_limit": line.split(",")[-1].strip() if line else None,
    }
