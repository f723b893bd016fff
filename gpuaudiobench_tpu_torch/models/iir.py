"""IIRFilter: per-track 2nd-order Butterworth lowpass biquad at fs/4,
Q = 0.707, Direct Form II (cuda/bench_iir.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/iir.py``. The filter
state (z1, z2) of every track stays on the device and evolves across
iterations (the reference's persistent d_state, bench_iir.cu:19-43);
each iteration uploads the input block and reads the output and the new
state back in one copy. Validation replays the float32 NumPy golden
once per performed iteration, carrying state, and compares the last
block at 1e-4 and the final state at 1e-3 (bench_iir.cu:105-117). Under
spot verification the golden is replayed for the tracks the spot check
reads only (``checked_tracks``), so ``golden`` holds NaN elsewhere.

``--iirForm scan`` (the default) runs the per-sample recurrence,
``--iirForm blockstate`` m samples per step through the tables of
``ops.iir.blockstate_tables``; iir_block_m = 0 means 128 on the CUDA
kernel and 16 on the plain twin (the reference's Pallas and XLA
choices), clamped to a divisor of the buffer size.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.models.common import (
    StandardBufferBenchmark,
    expand_rows,
)
from gpuaudiobench_tpu_torch.ops import iir as iir_ops
from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients


def iir_reference(x: np.ndarray, coeffs, state: np.ndarray):
    """Float32 DF-II golden, op order of bench_iir.cu:170-197, vectorized
    over tracks: (y (T, S), state' (T, 2))."""
    b0, b1, b2, a1, a2 = (np.float32(c) for c in coeffs)
    z1 = state[:, 0].copy()
    z2 = state[:, 1].copy()
    y = np.empty_like(x)
    for n in range(x.shape[1]):
        xn = x[:, n]
        w = xn - a1 * z1 - a2 * z2
        y[:, n] = b0 * w + b1 * z1 + b2 * z2
        z2 = z1
        z1 = w
    return y, np.stack([z1, z2], axis=1)


class IIRBenchmark(StandardBufferBenchmark):
    name = "IIRFilter"
    tolerance = 1e-4  # output, bench_iir.cu:106
    state_tolerance = 1e-3  # final state, bench_iir.cu:114

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA
        self._block_m = None
        if cfg.iir_form == "blockstate":
            req = cfg.iir_block_m or (128 if self._impl == "cuda-kernel" else 16)
            self._block_m = iir_ops.blockstate_effective_m(self.buffer_size, req)

    def setup(self) -> None:
        self.setup_standard_buffers()
        coeffs = np.array(biquad_lowpass_coefficients(0.25), np.float32)
        self.load_state(self.host_input, coeffs,
                        np.zeros((self.track_count, 2), np.float32))

    def load_state(self, host_input: np.ndarray, coeffs: np.ndarray,
                   state: np.ndarray) -> None:
        """Resume from the given input block, (5,) coefficients and
        (tracks, 2) filter state (e.g. a JAX benchmark's mid-stream
        ``host_state``), then run one iteration. ``setup`` calls it with
        the seeded input, the fs/4 lowpass and the zero state."""
        if host_input is not self.host_input:
            self.set_input(host_input)
        coeffs = np.array(coeffs, np.float32)  # a writable copy
        state = np.array(state, np.float32)  # a writable copy
        if coeffs.shape != (5,) or state.shape != (self.track_count, 2):
            raise ValueError(
                f"{self.name}: need coeffs (5,) and state "
                f"({self.track_count}, 2), got {coeffs.shape} {state.shape}")
        self.coeffs = tuple(np.float32(c) for c in coeffs)
        self._coeffs_dev = self.put_replicated(coeffs)
        self._start_state = state.copy()
        self._state_dev = self.put_sharded(state)
        # The setup state, frozen for the device tier and the stream:
        # the wrappers never write their input state.
        self._timing_state = self._state_dev
        if self._block_m is not None:
            taps, u = iir_ops.blockstate_tables(self.coeffs, self._block_m)
            taps_d, u_d = self.put_replicated(taps), self.put_replicated(u)

            def filt(x, c, z):
                return iir_ops.iir_biquad_blockstate(x, c, taps_d, u_d, z)
        else:
            filt = iir_ops.iir_biquad
        self._filter = filt
        self._invocations = 0
        self.host_state = None
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y, self._state_dev = self._filter(x, self._coeffs_dev, self._state_dev)
        self.host_output, self.host_state = self.to_host_parts(
            [(y, 0), (self._state_dev, 0)])
        self._invocations += 1

    def device_iterate(self) -> None:
        self._filter(self._resident_input, self._coeffs_dev, self._timing_state)

    def stream_body(self):
        filt, c = self._filter, self._coeffs_dev

        def step(carry):
            x, z = carry
            y, z2 = filt(x, c, z)
            return (x, z2), probe(y)

        return step, (self._resident_input, self._timing_state)

    def overlap_body(self):
        """Input upload double-buffered against the biquad; the filter
        state carries block to block (the streaming dependency)."""
        filt, c = self._filter, self._coeffs_dev
        return ((lambda x, z: filt(x, c, z)), self.overlap_blocks(),
                self._state_dev)

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":
            return compare_abs(self.host_output, self.host_output,
                               self.tolerance, mode="none", label=self.name)
        rows = self.checked_tracks((self.track_count, 2))
        x, state = self.host_input, self._start_state.copy()
        if rows is not None:
            x, state = x[rows], state[rows]
        golden = None
        for _ in range(self._invocations):
            golden, state = iir_reference(x, self.coeffs, state)
        self.golden = expand_rows(golden, rows, self.host_input.shape)
        self.golden_state = expand_rows(state, rows, self.host_state.shape)
        v = compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} output",
        )
        v.merge_failure(compare_abs(
            self.host_state, self.golden_state, self.state_tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} state",
        ))
        return v

    def cost_model(self):
        n = self.total_elements()
        return {
            "flops": 9 * n,  # w = x - a1 z1 - a2 z2; y = b0 w + b1 z1 + b2 z2
            "hbm_bytes": (2 * n + 4 * self.track_count) * 4,
            "unit": "vpu",
        }

    def metadata(self):
        b0, b1, b2, a1, a2 = (float(c) for c in self.coeffs)
        md = {
            "filter": "butterworth_lowpass_fs4",
            "coefficients": {"b0": b0, "b1": b1, "b2": b2, "a1": a1, "a2": a2},
            "impl": self._impl,
            "form": self.cfg.iir_form,
        }
        if self._block_m is not None:
            md["blockM"] = self._block_m
        return md
