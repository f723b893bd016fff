"""NeuralAmp / NeuralAmpLSTM: streaming neural amp-model inference, the
suite's neural (GEMM) workload family.

PyTorch counterpart of ``gpuaudiobench_tpu/models/neuralamp.py``. The two
deployed architectures measure opposite compute regimes:

* NeuralAmp (arch "tcn"): a depth-L dilated causal TCN as batched
  (T, S, C) x (C, C) GEMMs in f32, bf16 or int8 (``ops.neuralamp.
  tcn_block``), run eagerly: ~10 launches a layer, each a large GEMM or
  a full pass over an activation.
* NeuralAmpLSTM (arch "lstm"): one recurrent layer, dense output and an
  input skip: 512 dependent (T, H) x (H, 4H) steps a block, in f32 or
  bf16. On a CUDA device every block is one replay of a CUDA graph
  (``ops.neuralamp.lstm_runner``); on the CPU the same steps run
  eagerly.

Both carry their state on the device across iterations, the TCN its
per-layer tails, the LSTM (h, c). Every tier owns what it writes:
``iterate``, the device tier, the stream and the overlap pass each have
their own LSTM graph with its own static buffers (made from the state the
tier starts at), and no block writes its inputs, so the entry state
(``_timing_state``) is never written. The device tier reruns one block
from the entry state; the stream starts from it too.

Validation replays the same input block through the f64 NumPy twins,
clamped at the proven steady block counts, relative to the golden's
peak, at the JAX package's tolerances (TOLERANCE). Set-up refuses TF32
matmuls: the f32 mode runs in full FP32, where the JAX package's runs at
``Precision.HIGH``. ``load_state`` takes a JAX stream's tails or (h, c)
and its block count.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_rel
from gpuaudiobench_tpu_torch.models.common import (
    StandardBufferBenchmark,
    check_full_fp32,
)
from gpuaudiobench_tpu_torch.ops import neuralamp as na
from gpuaudiobench_tpu_torch.ops.speedoflight import INT_MM_MULTIPLE
from gpuaudiobench_tpu_torch.utils import device as dev

# Relative to the golden's peak (the JAX package's table and margins).
TOLERANCE = {
    ("tcn", "f32"): 1e-4,
    ("tcn", "bf16"): 2e-2,
    ("tcn", "int8"): 5e-2,
    ("lstm", "f32"): 1e-4,
    ("lstm", "bf16"): 1e-3,
}


class NeuralAmpBenchmark(StandardBufferBenchmark):
    name = "NeuralAmp"

    def __init__(self, cfg: BenchConfig, device: torch.device,
                 arch: str = "tcn"):
        super().__init__(cfg, device)
        self.arch = arch
        self.name = "NeuralAmp" if arch == "tcn" else "NeuralAmpLSTM"
        self._tiers = {}

    def setup(self) -> None:
        cfg = self.cfg
        check_full_fp32(self.name)
        self.channels = cfg.neuralamp_channels
        self.layers = cfg.neuralamp_layers
        self.dtype = cfg.neuralamp_dtype
        if (self.arch, self.dtype) not in TOLERANCE:
            raise ValueError(
                f"{self.name} does not support --neuralampDtype "
                f"{self.dtype} (int8 is TCN-only: the LSTM's per-sample "
                "GEMMs are issue-bound, not compute-bound, so the "
                "integer path has nothing to win)")
        if self.dtype == "int8" and self.channels % INT_MM_MULTIPLE:
            raise ValueError(
                f"{self.name}: int8 needs --neuralampChannels a multiple of "
                f"{INT_MM_MULTIPLE} (torch._int_mm), got {self.channels}")
        self.tolerance = TOLERANCE[(self.arch, self.dtype)]
        self.setup_standard_buffers()

        t, c = self.track_count, self.channels
        if self.arch == "tcn":
            self.params_np = na.init_params(cfg.seed, c, self.layers)
            self._params = na.cast_params(self.params_np, self.dtype,
                                          self.device)
            state = na.init_tails(t, c, self.layers, self.dtype, self.device)
            weights = na.param_bytes(c, self.layers, self.dtype)
        else:
            self.params_np = na.init_lstm_params(cfg.seed, c)
            self._params = na.cast_lstm_params(self.params_np, self.dtype,
                                               self.device)
            state = tuple(torch.zeros((t, c), dtype=torch.float32,
                                      device=self.device) for _ in range(2))
            weights = na.lstm_param_bytes(c, self.dtype)
        self.track_alloc("weights", weights)
        self._set_state(state)
        self._invocations = 0
        self.track_alloc("state", sum(s.numel() * s.element_size()
                                      for s in state))
        self.iterate()

    def _set_state(self, state) -> None:
        """``state`` becomes the entry state and iterate's; every tier's
        LSTM graph is made anew from the state it starts at."""
        self._timing_state = tuple(state)
        self._state = self._timing_state
        self._tiers = {}

    def load_state(self, state: Sequence, invocations: int) -> None:
        """Take a stream's state as NumPy arrays (the TCN's tails, in any
        float dtype; the LSTM's (h, c)) and the number of blocks it has
        run; the next ``iterate`` continues from it and the golden counts
        from ``invocations``."""
        want = [tuple(s.shape) for s in self._timing_state]
        got = [tuple(np.shape(a)) for a in state]
        if got != want:
            raise ValueError(f"{self.name}: state shapes {got}, want {want}")
        self._set_state(tuple(
            dev.to_device(np.array(a, np.float32), self.device).to(s.dtype)
            for a, s in zip(state, self._timing_state)))
        self._invocations = int(invocations)

    def _block_fn(self, state):
        """A block function ``f(x, state) -> (y, state')``: the TCN block,
        or the LSTM block over a graph of its own (on CUDA), made from the
        resident input and ``state``."""
        if self.arch == "tcn":
            params, layers, dtype = self._params, self.layers, self.dtype
            return lambda x, s: na.tcn_block(x, s, params, layers, dtype)
        run = na.lstm_runner(self._params, self.dtype, self._resident_input,
                             *state)

        def lstm(x, s):
            y, h, c = run(x, *s)
            return y, (h, c)

        return lstm

    def _tier(self, name: str, state):
        """The block function of tier ``name``, made at its first block
        from the state that tier starts at."""
        if name not in self._tiers:
            self._tiers[name] = self._block_fn(state)
        return self._tiers[name]

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y, self._state = self._tier("iterate", self._state)(x, self._state)
        self.host_output = dev.from_device(y)
        self._invocations += 1

    def device_iterate(self) -> None:
        """One block from the entry state (on CUDA the LSTM graph copies
        the resident input and the state in: 384 KiB at 128 tracks)."""
        self._tier("device", self._timing_state)(self._resident_input,
                                                 self._timing_state)

    def overlap_body(self):
        """From iterate's state; the LSTM's outputs are its graph's,
        rewritten by the next block."""
        return (self._block_fn(self._state), self.overlap_blocks(),
                self._state)

    def stream_body(self):
        block = self._block_fn(self._timing_state)

        def step(carry):
            x, state = carry
            y, state = block(x, state)
            # A new (1,) tensor, enqueued before the next replay rewrites
            # the LSTM graph's y.
            return (x, state), probe(y)

        return step, (self._resident_input, self._timing_state)

    def cost_model(self):
        t, s, c = self.track_count, self.buffer_size, self.channels
        # int8 stores activations and tails in bf16 like the bf16 mode.
        per = 2 if self.dtype in ("bf16", "int8") else 4
        unit = {"f32": "mxu", "bf16": "mxu_bf16",
                "int8": "mxu_int8"}[self.dtype]
        if self.arch == "lstm":
            return {
                # One (T, H+1) x (H+1, 4H) gate GEMM + the dense out a
                # sample; the gate nonlinearities are O(H) beside them.
                "flops": int(t * s * (2 * (c + 1) * 4 * c + 2 * c)),
                # x / y, the (h, c) state and the weights once.
                "hbm_bytes": int(
                    2 * t * s * 4 + 4 * t * c * 4
                    + na.lstm_param_bytes(c, self.dtype)),
                "unit": unit,
            }
        l, k = self.layers, na.KERNEL
        act = t * s * c * per  # one (T, S, C) activation
        tail_bytes = 2 * sum(
            t * ctx * c * per for ctx in na.context_lengths(l))
        return {
            # GEMM MACs only (the in/out 1x1 convs and tanh are O(C) a
            # sample against the layers' O(K*C^2)).
            "flops": int(t * s * (2 * c + 2 * k * c * c * l + 2 * c)),
            # Each layer's input read and output written once, the
            # carried tails read and written, the weights, x and y.
            "hbm_bytes": int(
                (2 * l + 2) * act + tail_bytes
                + na.param_bytes(self.channels, l, self.dtype)
                + 2 * t * s * 4),
            "unit": unit,
        }

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name)
        if self.arch == "tcn":
            golden = na.tcn_reference(
                self.host_input, self._invocations, self.params_np,
                self.layers)
        else:
            golden = na.lstm_reference(
                self.host_input, self._invocations, self.params_np)
        self.golden = golden
        floor = float(np.abs(golden).max())
        return compare_rel(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor)

    def metadata(self):
        md = {
            "arch": self.arch,
            "channels": self.channels,
            "dtype": self.dtype,
        }
        if self.arch == "tcn":
            md.update({
                "layers": self.layers,
                "receptiveField": na.receptive_field(self.layers),
                "steadyBlocks": na.steady_blocks(
                    self.layers, self.buffer_size),
                "paramBytes": na.param_bytes(
                    self.channels, self.layers, self.dtype),
            })
        else:
            md.update({
                "steadyBlocks": na.lstm_steady_blocks(self.buffer_size),
                "paramBytes": na.lstm_param_bytes(
                    self.channels, self.dtype),
                # one CUDA graph replay a block on the card
                "blockForm": ("cuda-graph" if self.device.type == "cuda"
                              else "eager"),
            })
        # f32 GEMMs in full FP32 (TF32 off): set-up refuses anything else.
        md["matmulPrecision"] = torch.get_float32_matmul_precision()
        return md
