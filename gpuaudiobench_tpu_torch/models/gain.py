"""gain: out = 2.0 * in per sample (cuda/bench_gain.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/gain.py``; tolerance
1e-5 against the float32 golden (bench_gain.cu:78).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_tpu_torch.models.common import StandardBufferBenchmark
from gpuaudiobench_tpu_torch.ops.elementwise import gain_op
from gpuaudiobench_tpu_torch.utils import device as dev

GAIN_VALUE = 2.0  # benchmark_constants.cuh:6 (GAIN_VALUE)


class GainBenchmark(StandardBufferBenchmark):
    name = "gain"
    tolerance = 1e-5  # bench_gain.cu:78

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.golden = (np.float32(GAIN_VALUE) * self.host_input).astype(np.float32)
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        self.host_output = dev.from_device(gain_op(x, GAIN_VALUE))

    def device_iterate(self) -> None:
        gain_op(self._resident_input, GAIN_VALUE)

    def stream_body(self):
        return self.stateless_stream(lambda x: gain_op(x, GAIN_VALUE))

    def cost_model(self):
        n = self.total_elements()
        return {"flops": n, "hbm_bytes": 2 * n * 4, "unit": "fp32"}
