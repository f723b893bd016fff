"""GainStats: gain (x0.5) plus per-track [mean, max] statistics
(cuda/bench_gainstats.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/gainstats.py``. The
stats reduce the *input* samples (bench_gainstats.cu:15-30); the gain
applies only to the output buffer. Output at 1e-5, stats at 1e-4
(bench_gainstats.cu:88, :100). The output and the stats come back to
the host in one device-to-host copy per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.models.common import StandardBufferBenchmark
from gpuaudiobench_tpu_torch.ops.elementwise import gain_stats_op
from gpuaudiobench_tpu_torch.utils import device as dev

GAINSTATS_GAIN = 0.5  # benchmark_constants.cuh:7 (the CUDA value)
NSTATS = 2


def _fused(x: torch.Tensor) -> torch.Tensor:
    """Output and stats in one flat buffer, for one readback."""
    y, stats = gain_stats_op(x, GAINSTATS_GAIN)
    return torch.cat([y.reshape(-1), stats.reshape(-1)])


class GainStatsBenchmark(StandardBufferBenchmark):
    name = "GainStats"
    tolerance = 1e-5  # output, bench_gainstats.cu:88
    stats_tolerance = 1e-4  # stats buffer, bench_gainstats.cu:100

    def setup(self) -> None:
        self.setup_standard_buffers()
        x64 = self.host_input.astype(np.float64)
        self.golden = (np.float32(GAINSTATS_GAIN) * self.host_input).astype(np.float32)
        self.golden_stats = np.stack(
            [x64.mean(axis=1), x64.max(axis=1)], axis=1
        ).astype(np.float32)
        self.host_stats = None
        self.iterate()

    def iterate(self) -> None:
        buf = dev.from_device(_fused(self.put_input(self.host_input)))
        n = self.total_elements()
        self.host_output = buf[:n].reshape(self.track_count, self.buffer_size)
        self.host_stats = buf[n:].reshape(self.track_count, NSTATS)

    def device_iterate(self) -> None:
        gain_stats_op(self._resident_input, GAINSTATS_GAIN)

    def stream_body(self):
        return self.stateless_stream(_fused)

    def cost_model(self):
        n = self.total_elements()
        return {
            "flops": 3 * n,  # gain mul + mean-add + max-cmp per sample
            "hbm_bytes": (2 * n + 2 * self.track_count) * 4,
            "unit": "fp32",
        }

    def validate(self) -> ValidationData:
        v = compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} output",
        )
        v.merge_failure(compare_abs(
            self.host_stats, self.golden_stats, self.stats_tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} stats",
        ))
        return v

    def metadata(self):
        return {"gain": GAINSTATS_GAIN, "nStats": NSTATS}
