"""Conv1D: direct time-domain FIR per track with per-track windowed-sinc
IRs (cuda/bench_conv1d.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/conv1d.py``. The IR
length defaults to 1024 (bench_conv1d.cuh:11); the IR bank stays on the
device across iterations (the texture-object analog,
bench_conv1d.cu:123-157). Each iteration uploads the input block, runs
the hand-written CUDA kernel (``ops.conv.conv1d_direct``) and reads the
track-major output back. Golden: the float64 direct convolution
``conv1d_reference`` at 1e-3 absolute (bench_conv1d.cu:108). Under spot
verification it is computed for the tracks the spot check reads only
(``checked_tracks``), so ``golden`` holds NaN elsewhere.

Edge modes: "clamp" (the default) keeps the window inside each track;
"bleed" reads the flat track-major buffer, reaching back across as many
earlier tracks as the IR needs, as the golden and the CUDA reference do.

Under ``--dataParallel`` each rank holds its tracks and their IRs. In
bleed mode the window of a rank's first tracks reaches into the tracks
of earlier ranks: ceil((L - 1) / S) of them, the halo, which may span
several ranks. Each rank takes the last min(halo, its tracks) tracks of
every rank in one ``all_gather``, prepends the halo to its block (zeros
before the first track) with zero IRs, runs the kernel and drops the
halo's rows. Clamp mode needs no halo. (The JAX package's XLA bleed pads
one track only and misses its golden where L - 1 > S.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.models.common import (
    StandardBufferBenchmark,
    expand_rows,
)
from gpuaudiobench_tpu_torch.ops.conv import conv1d_direct
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.utils.data import conv1d_impulse_responses

DEFAULT_IR_LENGTH = 1024  # bench_conv1d.cuh:11


def conv1d_reference(x: np.ndarray, ir: np.ndarray, edge_mode: str = "clamp",
                     rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Float64 direct convolution golden (bench_conv1d.cu:188-208), float32
    out; for the tracks ``rows`` only, (len(rows), S), when given."""
    t, s = x.shape
    l = ir.shape[1]
    tracks = np.arange(t) if rows is None else np.asarray(rows)
    out = np.empty((len(tracks), s), np.float64)
    ir64 = ir.astype(np.float64)
    if edge_mode == "bleed":
        # The window reaches at most L-1 samples into preceding tracks of
        # the flat buffer (bench_conv1d.cu:197-201), so prepend that tail.
        flat = np.concatenate([np.zeros(l - 1, np.float64),
                               x.astype(np.float64).ravel()])
        for i, track in enumerate(tracks):
            seg = flat[track * s: track * s + (l - 1) + s]
            out[i] = np.convolve(seg, ir64[track])[l - 1: l - 1 + s]
    else:
        for i, track in enumerate(tracks):
            out[i] = np.convolve(x[track].astype(np.float64),
                                 ir64[track])[:s]
    return out.astype(np.float32)


class Conv1DBenchmark(StandardBufferBenchmark):
    name = "Conv1D"
    tolerance = 1e-3  # bench_conv1d.cu:108

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA
        self.ir_length = cfg.ir_length or DEFAULT_IR_LENGTH
        self.edge_mode = cfg.conv_edge_mode

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.load_data(self.host_input, conv1d_impulse_responses(
            self.track_count, self.ir_length))

    def load_data(self, host_input: np.ndarray, ir: np.ndarray) -> None:
        """Take the input block and the (tracks, L) IR bank (e.g. a JAX
        benchmark's ``host_input`` and ``ir``), place the IRs on the
        device and run one iteration. ``setup`` calls it with the seeded
        input and the windowed-sinc bank."""
        if host_input is not self.host_input:
            self.set_input(host_input)
        if ir.dtype != np.float32 or ir.ndim != 2 or ir.shape[0] != self.track_count:
            raise ValueError(
                f"{self.name}: need a float32 ({self.track_count}, L) IR "
                f"bank, got {ir.dtype} {ir.shape}")
        self.ir = ir
        self.ir_length = ir.shape[1]
        self._ir_dev = self.put_sharded(ir)
        # The tracks of earlier ranks a bleed window reaches, and the IR
        # bank with zero rows for them.
        self._halo = 0
        if self.edge_mode == "bleed" and self.dp_ranks > 1:
            self._halo = -(-(self.ir_length - 1) // self.buffer_size)
            self._ir_halo = torch.cat([self._ir_dev.new_zeros(
                (self._halo, self.ir_length)), self._ir_dev])
        self.track_alloc("irBank", ir.nbytes)
        self.golden = None
        self.iterate()

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        # The wrapper launches the kernel on CUDA tensors; only CPU
        # tensors take its plain twin.
        if self._halo:
            xh = torch.cat([self._halo_tracks(x), x])
            return conv1d_direct(xh, self._ir_halo, "bleed")[self._halo:]
        return conv1d_direct(x, self._ir_dev, self.edge_mode)

    def _halo_tracks(self, x: torch.Tensor) -> torch.Tensor:
        """The ``_halo`` tracks before this rank's first, zeros before
        track 0: every rank's last min(halo, tracks a rank) tracks,
        gathered, hold them."""
        h = self._halo
        k = min(h, x.shape[0])
        tails = col.all_gather(x[-k:], self._mesh, "dp", 0)
        prev = tails[:self.dp_rank * k][-h:]
        if prev.shape[0] < h:
            prev = torch.cat([x.new_zeros((h - prev.shape[0], x.shape[1])),
                              prev])
        return prev

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        self.host_output = self.to_host(self._run(x))

    def device_iterate(self) -> None:
        self._run(self._resident_input)

    def stream_body(self):
        return self.stateless_stream(self._run)

    def overlap_body(self):
        return self.stateless_overlap(self._run)

    def validate(self) -> ValidationData:
        if self.cfg.verification != "none":
            rows = self.checked_tracks()
            self.golden = expand_rows(
                conv1d_reference(self.host_input, self.ir, self.edge_mode,
                                 rows),
                rows, self.host_input.shape)
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        t, s, l = self.track_count, self.buffer_size, self.ir_length
        return {
            "flops": 2 * t * s * l,  # MAC per (sample, tap)
            "hbm_bytes": (2 * t * s + t * l) * 4,
            "unit": "vpu",
        }

    def metadata(self):
        return {"irLength": self.ir_length, "edgeMode": self.edge_mode,
                "impl": self._impl}
