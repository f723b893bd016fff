"""BiquadChain: a serial chain of 10 biquads per track (extension).

PyTorch counterpart of ``gpuaudiobench_tpu/models/biquad_chain.py`` (the
reference's unregistered Metal extra, kernels_extra.metal:16-67): a
10-stage cascade of Butterworth lowpass biquads with cutoffs staggered
from fs/4 to fs/8, through the systolic cascade kernel. Each round trip
runs from the entry states (zero unless ``load_state`` gave others),
which stay resident on the device, so neither the round trip nor the
device tier uploads them; the stream carries the states from block to
block. Output tolerance 1e-4, states 1e-3, against the float32 NumPy
golden run stage by stage (under spot verification for the tracks the
spot check reads only, NaN elsewhere). Validation also reruns the block
through the per-sample chain cascade, the systolic kernel's oracle, and
holds the two to 1e-6: the reference keeps that cross-check in its
tests only.
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
from gpuaudiobench_tpu_torch.models.iir import iir_reference
from gpuaudiobench_tpu_torch.ops.iir import iir_cascade, iir_cascade_chain
from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients

NUM_STAGES = 10  # kernels_extra.metal caps the chain at 10


class BiquadChainBenchmark(StandardBufferBenchmark):
    name = "BiquadChain"
    tolerance = 1e-4
    state_tolerance = 1e-3
    chain_tolerance = 1e-6  # tests/test_pallas_ops.py:187-190

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA

    def setup(self) -> None:
        self.setup_standard_buffers()
        coeffs = np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * k)
                           for k in range(NUM_STAGES)], np.float32)
        self.load_state(self.host_input, coeffs, np.zeros(
            (NUM_STAGES, self.track_count, 2), np.float32))

    def load_state(self, host_input: np.ndarray, coeffs: np.ndarray,
                   states: np.ndarray) -> None:
        """Take the input block, (K, 5) coefficients and (K, tracks, 2)
        entry states (e.g. a JAX stream's carried states), compute the
        golden from them and run one iteration."""
        if host_input is not self.host_input:
            self.set_input(host_input)
        coeffs = np.array(coeffs, np.float32)  # a writable copy
        states = np.array(states, np.float32)  # a writable copy
        want = (NUM_STAGES, self.track_count, 2)
        if coeffs.shape != (NUM_STAGES, 5) or states.shape != want:
            raise ValueError(
                f"{self.name}: need coeffs ({NUM_STAGES}, 5) and states "
                f"{want}, got {coeffs.shape} {states.shape}")
        self.stage_coeffs = [tuple(np.float32(c) for c in row) for row in coeffs]
        self._coeffs_dev = self.put_replicated(coeffs)
        self._entry_states = states.copy()
        self._states_dev = self.put_spec(states, None, "dp")

        rows = self.checked_tracks(states.shape)
        y = self.host_input if rows is None else self.host_input[rows]
        golden_states = []
        for k in range(NUM_STAGES):
            z = states[k] if rows is None else states[k][rows]
            y, z = iir_reference(y, self.stage_coeffs[k], z)
            golden_states.append(z)
        self.golden = expand_rows(y, rows, self.host_input.shape)
        self.golden_states = expand_rows(np.stack(golden_states), rows,
                                         states.shape, axis=1)
        self.host_states = None
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y, zs = iir_cascade(x, self._coeffs_dev, self._states_dev)
        self.host_output, self.host_states = self.to_host_parts(
            [(y, 0), (zs, 1)])

    def device_iterate(self) -> None:
        iir_cascade(self._resident_input, self._coeffs_dev, self._states_dev)

    def stream_body(self):
        coeffs = self._coeffs_dev

        def step(carry):
            x, states = carry
            y, zs = iir_cascade(x, coeffs, states)
            return (x, zs), probe(y)

        return step, (self._resident_input, self._states_dev)

    def overlap_body(self):
        """Input upload double-buffered against the cascade; the 10
        stages' state carries block to block from the entry states."""
        coeffs = self._coeffs_dev
        return ((lambda x, zs: iir_cascade(x, coeffs, zs)),
                self.overlap_blocks(), self._states_dev)

    def validate(self) -> ValidationData:
        mode, limit = self.cfg.verification, self.cfg.spot_sample_limit
        v = compare_abs(self.host_output, self.golden, self.tolerance,
                        mode=mode, limit=limit, label=f"{self.name} output")
        v.merge_failure(compare_abs(
            self.host_states, self.golden_states, self.state_tolerance,
            mode=mode, limit=limit, label=f"{self.name} states"))
        if mode == "none":
            return v
        # The systolic cascade against its per-sample chain form, which
        # the reference checks only in its tests: the chain reruns the
        # round trip's block, and output and states must agree to 1e-6.
        y, zs = iir_cascade_chain(self._resident_input, self._coeffs_dev,
                                  self._states_dev)
        chain_y, chain_zs = self.to_host_parts([(y, 0), (zs, 1)])
        v.merge_failure(compare_abs(
            self.host_output, chain_y, self.chain_tolerance, mode=mode,
            limit=limit, label=f"{self.name} systolic vs chain output"))
        v.merge_failure(compare_abs(
            self.host_states, chain_zs, self.chain_tolerance, mode=mode,
            limit=limit, label=f"{self.name} systolic vs chain states"))
        return v

    def cost_model(self):
        n = self.total_elements()
        return {
            "flops": 9 * NUM_STAGES * n,
            "hbm_bytes": (2 * n + 4 * NUM_STAGES * self.track_count) * 4,
            "unit": "vpu",
        }

    def metadata(self):
        return {"numStages": NUM_STAGES, "impl": self._impl}
