"""Speed-of-light bodies: the measured denominators of the port's roofline.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/speedoflight.py``. What
each measures on an H100 (the JAX names kept, so that one peaks schema
serves both packages):

* ``fma_chain``    -- the FP32 FMA rate of the CUDA cores (peak key
                      ``vpu_f32_flops``): k dependent ``y <- y*m + c``
                      passes over (rows, width) f32 held in registers.
* ``fma_vmem``     -- the shared-memory pass rate (``vmem_bytes_per_sec``):
                      the same chain with the carry loaded from and stored
                      to shared memory on every pass (8 B an element and
                      pass).
* ``stream_scale`` -- the HBM3 rate (``hbm_bytes_per_sec``): one read and
                      one write pass, y = 2x.
* ``matmul_bf16``  -- the tensor cores' bf16 rate, fp32 out
                      (``mxu_bf16_flops``).
* ``matmul_f32``   -- the delivered f32 GEMM rate in full FP32 with TF32
                      off (``mxu_f32_flops``), the port's f32 operating
                      precision.
* ``matmul_int8``  -- the tensor cores' int8 rate, int32 out
                      (``mxu_int8_flops``).

``fma_chain`` and ``fma_vmem`` wrap the hand-written CUDA kernels of
``csrc/speedoflight.cu``, which replace the Pallas ``_fma_kernel`` and
``_fma_vmem_kernel``; each rounds once a pass (an FMA). They launch them
through the ``torch.ops.gpuab.fma_{chain,vmem}_launch`` operators
(``ops/gpuab.py``), which an exported program calls too. Their plain twin
``fma_chain_plain`` runs the same loop on a tensor (a multiply and an add,
each rounded), for the CPU and for ``chip_smoke.py``'s comparison. The
wrappers run the twin only because their tensor lies on the CPU (and
call the operator, whose CPU implementation is the twin, while a CPU
program is traced); on a CUDA tensor they launch the kernel or raise. The
stream and the matmuls are plain PyTorch, as the JAX package left them
to XLA.

The chain y <- y*m + c composed k times has the closed form
y = x*m^k + c*(1 - m^k)/(1 - m) (``fma_golden``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpuaudiobench_tpu_torch.ops import gpuab

# FMA chain constants (the JAX module's). m pulls toward the fixed point
# c/(1-m) = 2, so values stay O(1) at any chain length.
FMA_M = 0.9995
FMA_C = 0.001

# Launches of the CUDA kernels, counted by the wrappers where they launch
# them (chip_smoke.py reads them to prove the main paths used them).
KERNEL_LAUNCHES: Dict[str, int] = {"fma_chain": 0, "fma_vmem": 0}

# The H100's int8 GEMM (torch._int_mm on CUDA) takes more than 16 rows and
# K and N that are multiples of 8.
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def fma_golden(x, k: int) -> np.ndarray:
    """Closed-form float64 golden: x*m^k + c*(1-m^k)/(1-m), as float32."""
    m = np.float64(np.float32(FMA_M))
    c = np.float64(np.float32(FMA_C))
    mk = m ** k
    return (np.asarray(x, np.float64) * mk
            + c * (1.0 - mk) / (1.0 - m)).astype(np.float32)


def fma_chain_plain(x: torch.Tensor, k: int, m: float = FMA_M,
                    c: float = FMA_C) -> torch.Tensor:
    """k passes of y*m + c over a copy of x (two roundings a pass), m and c
    rounded to float32 first."""
    m = float(np.float32(m))
    c = float(np.float32(c))
    y = x.clone()
    for _ in range(k):
        y = y * m + c
    return y


def _check(x: torch.Tensor, k: int, label: str) -> torch.device:
    if x.dtype != torch.float32:
        raise TypeError(f"{label}: x must be float32, got {x.dtype}")
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{label}: x must be 2-D and non-empty, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{label}: x must be contiguous")
    if isinstance(k, bool) or not isinstance(k, int) or k < 0:
        raise ValueError(f"{label}: k must be an int >= 0, got {k!r}")
    if k > 2 ** 31 - 1:
        raise ValueError(f"{label}: k ({k}) does not fit the kernel's int")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{label}: no kernel for {x.device}")
    return x.device


def _fma(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    dev = _check(x, k, name)
    if not gpuab.use_op(dev):
        return fma_chain_plain(x, k)
    return gpuab.call(f"{name}_launch", x, k, float(np.float32(FMA_M)),
                      float(np.float32(FMA_C)), counts=KERNEL_LAUNCHES,
                      key=name)


def fma_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """k FMA passes over (rows, width) f32, the chains in registers."""
    return _fma("fma_chain", x, k)


def fma_vmem(x: torch.Tensor, k: int) -> torch.Tensor:
    """k FMA passes over (rows, width) f32, the carry through shared
    memory on every pass."""
    return _fma("fma_vmem", x, k)


def stream_scale(x: torch.Tensor) -> torch.Tensor:
    """One full read and write pass: y = 2x."""
    return x * 2.0


# K halves of the bf16 product: each half accumulates on the tensor cores,
# and cuBLAS adds the second onto the first in f32 (the beta = 1 epilogue of
# addmm). One accumulation over all of K = 4,096 misses the reference's 1e-3
# on 329 of 16.8 M outputs (max 1.82e-3); halves meet it (max 8.9e-4), as
# tools/sol_bf16_split.py measured on an H100.
BF16_K_SPLITS = 2


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32 (``preferred_element_type=float32`` in JAX). On
    CUDA the sum of ``BF16_K_SPLITS`` K-chunk products, the first from
    ``torch.mm(..., out_dtype=torch.float32)``, the rest added by
    ``torch.addmm(c, ..., out_dtype=torch.float32)``; a PyTorch without
    those overloads raises rather than round the product to bf16. On the
    CPU both operands are upcast, which is exact."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul_bf16: operands must be bfloat16, got "
                        f"{a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return a.float() @ b.float()
    k = a.shape[1]
    bounds = [k * i // BF16_K_SPLITS for i in range(BF16_K_SPLITS + 1)]
    try:
        c = torch.mm(a[:, :bounds[1]], b[:bounds[1]], out_dtype=torch.float32)
        for lo, hi in zip(bounds[1:-1], bounds[2:]):
            c = torch.addmm(c, a[:, lo:hi], b[lo:hi], out_dtype=torch.float32)
        return c
    except (TypeError, NotImplementedError) as e:
        raise NotImplementedError(
            "matmul_bf16: this PyTorch has no torch.mm/addmm(..., "
            f"out_dtype=) ({e}); a bf16 product rounded to bf16 misses the "
            "1e-3 tolerance, so SOL_MXU_bf16 does not run (ROADMAP.md)") from e


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 x f32 -> f32 in full FP32: raises when TF32 matmuls are on
    (``torch.get_float32_matmul_precision() != "highest"``)."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul_f32: operands must be float32, got "
                        f"{a.dtype}, {b.dtype}")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "matmul_f32: float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; SOL_MXU_f32 "
            "measures full FP32 ('highest', TF32 off)")
    return torch.matmul(a, b)


def matmul_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 (``torch._int_mm``). Checks cuBLAS's shape
    rules on every device: more than 16 rows, K and N multiples of 8."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"matmul_int8: operands must be int8, got "
                        f"{a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_int8: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not multiply")
    rows, kk, n = a.shape[0], a.shape[1], b.shape[1]
    if (rows < INT_MM_MIN_ROWS or kk % INT_MM_MULTIPLE
            or n % INT_MM_MULTIPLE):
        raise ValueError(
            f"matmul_int8: ({rows}, {kk}) x ({kk}, {n}) needs more than 16 "
            "rows and K, N multiples of 8 (torch._int_mm on CUDA)")
    return torch._int_mm(a, b)
