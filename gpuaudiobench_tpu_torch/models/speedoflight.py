"""Speed-of-light benchmarks: the card's own roofline denominators.

PyTorch counterpart of ``gpuaudiobench_tpu/models/speedoflight.py``. Six
microbenchmarks whose achieved rates are the peaks every %-of-peak of the
port divides by (``utils/roofline.py``): SOL_VPU (the FP32 FMA rate of
the CUDA cores, through the ``fma_chain`` kernel), SOL_VMEM (the
shared-memory pass rate, through ``fma_vmem``), SOL_HBM (the HBM3 stream),
and SOL_MXU_bf16 / _f32 / _int8 (the GEMM rates of cuBLAS: tensor-core
bf16 and int8, full FP32). They run through the same harness as every
workload, with the reference's seeded host data, goldens and tolerances;
``python -m gpuaudiobench_tpu_torch.calibrate_peaks`` runs them on the
card and writes the rates to ``utils/measured_peaks.json``.

On the CPU the FMA benchmarks run the plain twin, whose rate is no peak:
metadata ``impl`` says which ran, and the calibration refuses a SOL_VMEM
row that is not the kernel's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import (
    ValidationData,
    compare_abs,
    compare_rel,
)
from gpuaudiobench_tpu_torch.ops import speedoflight as sol
from gpuaudiobench_tpu_torch.utils import device as dev
from gpuaudiobench_tpu_torch.utils.data import generate_random_audio

_WIDTH = 1024  # the reference's width of the 2-D working sets


def _rows(mib: int) -> int:
    return max(8, mib * (1024 * 1024 // 4) // _WIDTH)


class _SolBenchmark(Benchmark):
    """Shared scaffolding: a single-device microbenchmark validated by
    absolute error against its golden."""

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self.host_output = None
        self.golden = None

    def _reject_dp(self) -> None:
        self.reject_data_parallel(
            f"{self.name} measures single-chip peaks; --dataParallel "
            "does not apply (use ICIBandwidth for the interconnect)"
        )

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def _stream(self, fn, *args):
        def step(carry):
            return carry, probe(fn(*carry))

        return step, args


class SolVpuFmaBenchmark(_SolBenchmark):
    """The FP32 FMA rate: k chained y = y*m + c passes over (rows, 1024)
    f32 (``ops.speedoflight.fma_chain``), against the closed form."""

    name = "SOL_VPU"
    # One f32 rounding per FMA accumulates ~k*eps on O(1) values.
    tolerance = 5e-4

    def _working_mib(self) -> int:
        return self.cfg.sol_fma_mib

    def _kernel(self):
        return sol.fma_chain

    def setup(self) -> None:
        self._reject_dp()
        self._impl = self.resolve_impl()
        self._fn = self._kernel()
        self.k = self.cfg.sol_fma_k
        rows = _rows(self._working_mib())
        self.host_input = generate_random_audio(
            rows * _WIDTH, self.cfg.seed).reshape(rows, _WIDTH)
        self._resident = dev.to_device(self.host_input, self.device)
        self.golden = sol.fma_golden(self.host_input, self.k)
        self.track_alloc("fmaBuffer", self.host_input.nbytes * 2)
        self.iterate()

    def iterate(self) -> None:
        x = dev.to_device(self.host_input, self.device)
        self.host_output = dev.from_device(self._fn(x, self.k))

    def device_iterate(self) -> None:
        self._fn(self._resident, self.k)

    def stream_body(self):
        return self._stream(lambda x: self._fn(x, self.k), self._resident)

    def total_elements(self) -> int:
        return self.host_input.size

    def bytes_processed(self) -> int:
        return self.host_input.nbytes * 2

    def cost_model(self):
        n = self.host_input.size
        return {
            "flops": 2 * self.k * n,
            "hbm_bytes": 2 * n * 4,
            "unit": "vpu",
            "note": f"FMA chain k={self.k}; this measurement IS the vpu peak",
        }

    def metadata(self) -> Dict[str, Any]:
        return {"fmaK": self.k, "workingSetMiB": self.cfg.sol_fma_mib,
                "impl": self._impl}


class SolVmemBenchmark(SolVpuFmaBenchmark):
    """The shared-memory pass rate: the SOL_VPU chain with the carry
    loaded from and stored to shared memory on every pass
    (``ops.speedoflight.fma_vmem``), 8 B an element and pass. Same golden
    and run shape as SOL_VPU; only the kernel and the working set differ.
    Only the kernel measures shared-memory traffic: ``impl`` says whether
    it ran, and the calibration refuses the twin's rate."""

    name = "SOL_VMEM"

    def _working_mib(self) -> int:
        return self.cfg.sol_vmem_mib

    def _kernel(self):
        return sol.fma_vmem

    def cost_model(self):
        n = self.host_input.size
        return {
            "flops": 2 * self.k * n,
            "hbm_bytes": 2 * n * 4,
            # one load and one store of the carry a pass
            "vmem_bytes": self.k * 8 * n,
            "unit": "vpu",
            "note": f"VMEM-carried FMA chain k={self.k}; this "
                    "measurement IS the vmem peak"
                    + ("" if self._impl == "cuda-kernel" else
                       " (plain twin: NOT a shared-memory measurement)"),
        }

    def metadata(self) -> Dict[str, Any]:
        return {"fmaK": self.k, "workingSetMiB": self.cfg.sol_vmem_mib,
                "impl": self._impl}


class SolHbmStreamBenchmark(_SolBenchmark):
    """The HBM3 rate: one read and one write pass (y = 2x) over an array
    larger than the 50 MB L2 (``ops.speedoflight.stream_scale``)."""

    name = "SOL_HBM"
    tolerance = 0.0  # 2x is exact in f32

    def setup(self) -> None:
        self._reject_dp()
        rows = _rows(self.cfg.sol_stream_mib)
        self.host_input = generate_random_audio(
            rows * _WIDTH, self.cfg.seed).reshape(rows, _WIDTH)
        self._resident = dev.to_device(self.host_input, self.device)
        self.golden = (self.host_input * np.float32(2.0)).astype(np.float32)
        self.track_alloc("streamBuffer", self.host_input.nbytes * 2)
        self.iterate()

    def iterate(self) -> None:
        x = dev.to_device(self.host_input, self.device)
        self.host_output = dev.from_device(sol.stream_scale(x))

    def device_iterate(self) -> None:
        sol.stream_scale(self._resident)

    def stream_body(self):
        return self._stream(sol.stream_scale, self._resident)

    def total_elements(self) -> int:
        return self.host_input.size

    def bytes_processed(self) -> int:
        return self.host_input.nbytes * 2

    def cost_model(self):
        n = self.host_input.size
        return {
            "flops": n,
            "hbm_bytes": 2 * n * 4,
            "unit": "vpu",
            "note": "read+write stream; this measurement IS the hbm peak",
        }

    def metadata(self) -> Dict[str, Any]:
        return {"streamMiB": self.cfg.sol_stream_mib}


class SolMxuBenchmark(_SolBenchmark):
    """Square d x d x d GEMM rates: bf16 and int8 on the tensor cores,
    f32 in full FP32 (TF32 off), through cuBLAS (``ops.speedoflight``
    ``matmul_*``). Operands are cast at setup, never in the timed body."""

    _IN_BYTES = {"bf16": 2, "int8": 1, "f32": 4}
    _UNIT = {"bf16": "mxu_bf16", "int8": "mxu_int8", "f32": "mxu"}
    _FN = {"bf16": sol.matmul_bf16, "int8": sol.matmul_int8,
           "f32": sol.matmul_f32}

    def __init__(self, cfg, device: torch.device, dtype: str):
        super().__init__(cfg, device)
        self.dtype = dtype
        self.name = f"SOL_MXU_{dtype}"
        # The reference's tolerances, relative with the golden's peak as
        # the floor: bf16 operands multiply exactly in f32 and the d-term
        # sum rounds ~sqrt(d) eps; int8 is exact (int32 accumulation of
        # |operands| <= 127 at d <= 4096 stays below 2^31); f32 keeps the
        # reference's 5 sigma of a 3-pass bf16 product, which full FP32
        # meets with room.
        if dtype == "int8":
            self.tolerance = 1e-9
        elif dtype == "f32":
            self.tolerance = 5 * (2.0 ** -16) * (cfg.sol_matmul_dim ** 0.5)
        else:
            self.tolerance = 1e-3

    def _put(self, host: torch.Tensor) -> torch.Tensor:
        """A copy on the device with the host tensor's strides."""
        return host.to(self.device, copy=True)

    def setup(self) -> None:
        self._reject_dp()
        d = self.cfg.sol_matmul_dim
        a = generate_random_audio(d * d, self.cfg.seed).reshape(d, d)
        b = generate_random_audio(d * d, self.cfg.seed + 1).reshape(d, d)
        if self.dtype == "bf16":
            # Rounded to bf16 (nearest even, as JAX casts) on the host; the
            # golden sees the same values the tensor cores do.
            ta = torch.from_numpy(a).to(torch.bfloat16)
            tb = torch.from_numpy(b).to(torch.bfloat16)
            a, b = ta.float().numpy(), tb.float().numpy()
        elif self.dtype == "int8":
            a = np.clip(np.round(a * 127.0), -127, 127).astype(np.int8)
            b = np.clip(np.round(b * 127.0), -127, 127).astype(np.int8)
            # B column-major (the same values, K contiguous): cuBLAS's int8
            # GEMM takes its tensor-core path for that layout only; a
            # row-major B runs a slower kernel. Uploads keep the strides.
            ta = torch.from_numpy(a)
            tb = torch.from_numpy(np.ascontiguousarray(b.T)).t()
        else:
            ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        self._fn = self._FN[self.dtype]
        self.host_a, self.host_b = ta, tb
        self._ra, self._rb = self._put(ta), self._put(tb)
        if self.dtype == "int8":
            # The exact integer golden, from float64 BLAS: every product
            # and partial sum is an integer below 2^53, so none rounds
            # (numpy's int64 matmul has no BLAS and takes a minute at 4096).
            g = a.astype(np.float64) @ b.astype(np.float64)
            if float(np.abs(g).max()) >= 2.0 ** 31:
                raise ValueError(f"{self.name}: int32 accumulation would "
                                 "overflow at this dimension")
            self.golden = g
        else:
            # f32 BLAS golden (bf16 inputs upcast: products f32-exact).
            self.golden = (a.astype(np.float32)
                           @ b.astype(np.float32)).astype(np.float32)
        in_bytes = self._IN_BYTES[self.dtype]
        self.track_alloc("matmulA", d * d * in_bytes)
        self.track_alloc("matmulB", d * d * in_bytes)
        self.track_alloc("matmulOut", d * d * 4)
        self.iterate()

    def iterate(self) -> None:
        out = self._fn(self._put(self.host_a), self._put(self.host_b))
        self.host_output = dev.from_device(out)

    def device_iterate(self) -> None:
        self._fn(self._ra, self._rb)

    def stream_body(self):
        return self._stream(self._fn, self._ra, self._rb)

    def validate(self) -> ValidationData:
        # Relative with a zero-crossing floor: entries are sums of d O(1)
        # terms, so |golden| spans orders of magnitude.
        floor = self.tolerance * float(np.abs(self.golden).max() or 1.0)
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def total_elements(self) -> int:
        return self.cfg.sol_matmul_dim ** 2

    def transfer_model(self):
        """iterate() uploads both operands and reads one output back."""
        d = self.cfg.sol_matmul_dim
        in_bytes = self._IN_BYTES[self.dtype]
        return {"h2d_bytes": 2 * d * d * in_bytes, "d2h_bytes": d * d * 4}

    def bytes_processed(self) -> int:
        d = self.cfg.sol_matmul_dim
        return 2 * d * d * self._IN_BYTES[self.dtype] + d * d * 4

    def cost_model(self):
        d = self.cfg.sol_matmul_dim
        return {
            "flops": 2 * d ** 3,
            "hbm_bytes": self.bytes_processed(),
            "unit": self._UNIT[self.dtype],
            "note": f"{d}^3 {self.dtype} matmul; this measurement IS "
                    "the mxu peak",
        }

    def metadata(self) -> Dict[str, Any]:
        meta = {"matmulDim": self.cfg.sol_matmul_dim, "dtype": self.dtype}
        if self.dtype == "f32":
            meta["matmulPrecision"] = "highest"
        return meta
