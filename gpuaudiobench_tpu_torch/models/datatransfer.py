"""datacopy*: host<->device transfer benchmarks at five input/output
ratios (cuda/bench_datatransfer.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/datatransfer.py``. The
pool is ``transfer_mib`` MiB of floats (10 by default,
bench_datatransfer.cuh:703 BASE_BUFFER_SIZE; the poster's tab5 used 100
MiB); per ratio the input is ratio_in of the pool, uploaded every
iteration, and the output ratio_out of it, read back, with the device
copying the input portion and synthesizing 0.5 + 0.5*sin(i*0.001) beyond
it (``ops.elementwise.data_transfer_op``). The measured path is the
host<->device link.

On a CUDA device the input is staged at set-up in a page-locked buffer
(the reference's cudaMallocHost, cuda/bench_utils.cu:101-155), and every
upload copies from it; the read-back stays pageable, as in the JAX
package. ``metadata()["transferMemoryClass"]`` records which path the
uploads took and, on a CUDA device, an A/B of pinned against pageable
copies in both directions.

Under ``--dataParallel N`` each rank uploads its 1/N of the input floats
and writes its 1/N of the output floats; both counts must divide by N.
Output shard r copies the input floats [r O/N, (r + 1) O/N), which lie on
other ranks' input shards wherever the input and output sizes differ:
every rank takes the whole input by one ``all_gather`` of the shards
before it writes its slice. The input is staged in pinned memory only on
one rank, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.ops.elementwise import data_transfer_op
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.utils import device as dev
from gpuaudiobench_tpu_torch.utils.data import generate_uniform01

DATACOPY_CONFIGS = {
    "datacopy0199": (0.01, 0.99),
    "datacopy2080": (0.20, 0.80),
    "datacopy5050": (0.50, 0.50),
    "datacopy8020": (0.80, 0.20),
    "datacopy9901": (0.99, 0.01),
}
AB_REPS = 5


def transfer_golden(host_input: np.ndarray, output_size: int) -> np.ndarray:
    """The input portion, then 0.5 + 0.5*sin(i*0.001) over a float32
    index, in float32 NumPy."""
    idx = np.arange(output_size, dtype=np.float32)
    golden = (0.5 + 0.5 * np.sin(idx * np.float32(0.001))).astype(np.float32)
    n = min(host_input.shape[0], output_size)
    golden[:n] = host_input[:n]
    return golden


class DataTransferBenchmark(Benchmark):
    tolerance = 1e-5  # bench_datatransfer.cu:115

    def __init__(self, cfg: BenchConfig, device: torch.device, name: str):
        super().__init__(cfg, device)
        self.name = name
        rin, rout = DATACOPY_CONFIGS[name]
        base = cfg.transfer_mib * 1024 * 1024 // 4
        self.input_size = int(base * rin)
        self.output_size = int(base * rout)
        self.host_input = None
        self.host_output = None
        self.golden = None
        self._pinned_input = None
        self._resident_input = None
        self._transfer_class = None

    def setup(self) -> None:
        # dp shards the flat transfer over the ranks; both portions must
        # split evenly.
        self.setup_sharding(self.input_size, "input floats")
        if self.cfg.data_parallel > 1 and \
                self.output_size % self.cfg.data_parallel != 0:
            raise ValueError(
                f"output floats ({self.output_size}) must be divisible "
                f"by --dataParallel ({self.cfg.data_parallel})"
            )
        self.host_input = generate_uniform01(self.input_size, self.cfg.seed)
        self.track_alloc("inputBuffers", self.input_size * 4 * 2)
        self.track_alloc("outputBuffers", self.output_size * 4 * 2)
        if self.cfg.data_parallel <= 1:
            self._pinned_input = dev.stage_pinned(self.host_input,
                                                  self.device)
        self._resident_input = self.put_sharded(self.host_input)
        self.golden = transfer_golden(self.host_input, self.output_size)
        self.iterate()

    def _transfer(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's output floats from its input shard ``x``."""
        if self._mesh is None:
            return data_transfer_op(x, self.output_size)
        whole = col.all_gather(x, self._mesh, "dp", 0)
        part = self.dp_slice(self.output_size)
        return data_transfer_op(whole, self.output_size, part.start,
                                part.stop)

    def iterate(self) -> None:
        if self._pinned_input is not None:
            x = dev.upload(self._pinned_input, self.device)
        else:
            x = self.put_sharded(self.host_input)
        self.host_output = self.to_host(self._transfer(x))

    def device_iterate(self) -> None:
        self._transfer(self._resident_input)

    def overlap_body(self):
        """The upload is the workload here: the purest serial against
        pipelined A/B. On a CUDA device the two blocks are two pinned
        buffers, like the pinned ring a DAW would cycle."""
        out_size = self.output_size
        blocks = [self.host_input, np.negative(self.host_input)]
        if self._pinned_input is not None:
            blocks = [self._pinned_input,
                      dev.stage_pinned(blocks[1], self.device)]
        return (lambda x, c: (data_transfer_op(x, out_size), c)), blocks, ()

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        # The device reads only the copied portion and writes the output;
        # the rest of the upload is link traffic, not device-memory
        # traffic. The sin runs only beyond the copied portion.
        copied = min(self.input_size, self.output_size)
        return {
            "flops": 2 * max(0, self.output_size - copied),
            "hbm_bytes": (copied + self.output_size) * 4,
            "unit": "vpu",
            "note": "measured path is host<->HBM, not HBM<->VMEM",
        }

    def bytes_processed(self) -> int:
        return (self.input_size + self.output_size) * 4

    def total_elements(self) -> int:
        return self.input_size + self.output_size

    def transfer_model(self):
        """Asymmetric by construction: the mix is the workload."""
        return {"h2d_bytes": self.input_size * 4,
                "d2h_bytes": self.output_size * 4}

    def _transfer_class_ab(self) -> dict:
        """Which memory the uploads came from and, on a CUDA device with
        the input staged (one rank), the median of ``AB_REPS`` wall times of each copy of the input's bytes,
        each ending in a synchronize: H2D from the pageable array and
        from the pinned buffer, D2H of a fresh device buffer (made before
        the clock starts) into pageable memory and, non_blocking, into a
        pinned buffer."""
        info = {
            "pinned_supported": self._pinned_input is not None,
            "h2d_path_used": ("pinned" if self._pinned_input is not None
                              else "pageable"),
        }
        if self.device.type != "cuda" or self._pinned_input is None:
            return info
        sync = torch.cuda.synchronize

        def med(fn, fresh=None) -> float:
            vals = []
            for _ in range(AB_REPS):
                arg = fresh() if fresh is not None else None
                sync(self.device)
                t0 = time.perf_counter()
                fn(arg)
                sync(self.device)
                vals.append((time.perf_counter() - t0) * 1e3)
            return round(sorted(vals)[len(vals) // 2], 4)

        def fresh():
            return self._resident_input.clone()

        pinned_out = torch.empty(self._resident_input.shape,
                                 dtype=torch.float32, pin_memory=True)
        info["ab_mib"] = round(self.input_size * 4 / 2**20, 3)
        info["h2d_pageable_ms"] = med(
            lambda _: dev.to_device(self.host_input, self.device))
        info["h2d_pinned_ms"] = med(
            lambda _: dev.upload(self._pinned_input, self.device))
        info["d2h_pageable_ms"] = med(lambda t: t.cpu(), fresh)
        info["d2h_pinned_ms"] = med(
            lambda t: pinned_out.copy_(t, non_blocking=True), fresh)
        return info

    def metadata(self):
        if self._transfer_class is None:
            self._transfer_class = self._transfer_class_ab()
        return {
            "inputFloats": self.input_size,
            "outputFloats": self.output_size,
            "inputMiB": self.input_size * 4 / 2**20,
            "outputMiB": self.output_size * 4 / 2**20,
            "transferMemoryClass": self._transfer_class,
        }
