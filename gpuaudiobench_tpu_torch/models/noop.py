"""NoOp: the round-trip overhead benchmark (cuda/bench_noop.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/noop.py``: upload one
block, copy it on the device (``copy_op``, a validatable no-op), read
it back. On the card the round trip is the two pageable copies and one
launch. Golden: out == in at 1e-5 (bench_noop.cu:838-856).
"""

from __future__ import annotations

from gpuaudiobench_tpu_torch.models.common import StandardBufferBenchmark
from gpuaudiobench_tpu_torch.ops.elementwise import copy_op
from gpuaudiobench_tpu_torch.utils import device as dev


class NoOpBenchmark(StandardBufferBenchmark):
    name = "NoOp"
    tolerance = 1e-5  # bench_noop.cu:838

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.golden = self.host_input.copy()
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        self.host_output = dev.from_device(copy_op(x))

    def device_iterate(self) -> None:
        copy_op(self._resident_input)

    def stream_body(self):
        return self.stateless_stream(copy_op)

    def cost_model(self):
        n = self.total_elements()
        return {"flops": 0, "hbm_bytes": 2 * n * 4, "unit": "fp32",
                "note": "copy in+out"}
