"""DAWSessionMix: a mixing session's graph as one streamed block, an
extension benchmark (the composite production workload).

PyTorch counterpart of ``gpuaudiobench_tpu/models/session.py``: per-track
EQ (a K-stage biquad cascade, ``--sessionEqStages`` 1-16), a post-fader
send bus summed over the tracks into a stereo partitioned-convolution
reverb (``ops.partconv.partconv_block``, shift form, on the 2-track bus),
then constant-power pan and gain into a stereo mix with the wet return
added. The EQ runs the port's ``ops.iir.iir_cascade``: the systolic
cascade kernel on the card (one launch a block), its plain twin on the
CPU. The bus sum and the mixdown are ``einsum``s in full FP32, as the
reference's ``Precision.HIGHEST`` is: the model refuses to run with TF32
matmuls on. Every op of the block is functional, so the device tier and
the stream run from the frozen entry state (``_timing``) as the
reference's do.

Validation is the reference's full-replay golden (``session_reference``):
the f32 EQ replayed block by block, the reverb as one f64 linear
convolution of the bus history, the replay clamped at P + settle + 8
blocks, relative to the golden's peak at 1e-3.

Under ``--dataParallel`` each rank holds its strips: their input, EQ
state (axis 1), sends and pans (axis 1 of pan2). Both sums over the
tracks, the send bus and the dry stereo mix, go into one (3, B) ``psum``
a block, the one collective of the graph; the reverb, its delay line and
the previous bus block are replicated, every rank running the same
reverb on the same bus. ``metadata.collectiveInventory`` lists the psum
where the JAX package writes its interconnect model.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_rel
from gpuaudiobench_tpu_torch.models.common import (
    StandardBufferBenchmark,
    check_full_fp32,
)
from gpuaudiobench_tpu_torch.models.iir import iir_reference
from gpuaudiobench_tpu_torch.ops.iir import iir_cascade
from gpuaudiobench_tpu_torch.ops.partconv import (
    num_partitions,
    partconv_block,
    partition_spectra,
)
from gpuaudiobench_tpu_torch.utils import device as dev
from gpuaudiobench_tpu_torch.utils.data import (
    biquad_lowpass_coefficients,
    reverb_impulse_responses,
)

DEFAULT_IR_LENGTH = 48000  # 1.0 s reverb tail at the default 48 kHz
WET_GAIN = 0.3  # reverb return level into the mix bus
# Upper bound on the EQ cascade's transient, in samples (the narrowest
# staggered cutoff's Butterworth poles have radius ~0.72).
_EQ_SETTLE_SAMPLES = 1024


def session_mix_params(track_count: int, seed: int):
    """Deterministic console settings: (send (T,), pan2 (2, T)); sends
    scaled 1/sqrt(T), pan2 the channel gain folded into constant-power pan
    weights, seeded apart from the audio (seed ^ 0x5E55)."""
    g = np.random.default_rng(seed ^ 0x5E55)
    gain = 0.5 + 0.5 * g.random(track_count)
    theta = g.random(track_count) * (np.pi / 2.0)
    send = (0.05 + 0.25 * g.random(track_count)) / math.sqrt(track_count)
    pan2 = np.stack([gain * np.cos(theta), gain * np.sin(theta)])
    return send.astype(np.float32), pan2.astype(np.float32)


def session_reference(
    x: np.ndarray,
    stage_coeffs,
    send: np.ndarray,
    pan2: np.ndarray,
    ir: np.ndarray,
    wet: float,
    k: int,
    clamp: Optional[int] = None,
) -> np.ndarray:
    """(2, B) golden mix at block ``k`` (1-indexed) of the stream that
    feeds ``x`` every block: the f32 EQ state replayed block by block, the
    reverb one f64 linear convolution of the bus history with the stereo
    IR; ``clamp`` bounds the replay length."""
    t, b = x.shape
    if clamp is not None:
        k = min(k, clamp)
    n_stages = len(stage_coeffs)
    eq_state = [np.zeros((t, 2), np.float32) for _ in range(n_stages)]
    bus_hist = np.zeros((k, b), np.float64)
    send64 = send.astype(np.float64)
    y = x
    for blk in range(k):
        y = x
        for s in range(n_stages):
            y, eq_state[s] = iir_reference(y, stage_coeffs[s], eq_state[s])
        bus_hist[blk] = send64 @ y.astype(np.float64)
    length = ir.shape[1]
    nfft = k * b + length
    spec = np.fft.rfft(bus_hist.ravel(), nfft)
    rev = np.fft.irfft(
        spec[None, :] * np.fft.rfft(ir.astype(np.float64), nfft, axis=1),
        nfft, axis=1,
    )[:, (k - 1) * b: k * b]
    dry = pan2.astype(np.float64) @ y.astype(np.float64)
    return (dry + wet * rev).astype(np.float32)


def session_block(x, coeffs, eq_states, send, pan2, prev, fre, fim,
                  h_re, h_im, psum=None):
    """One session block: (mix (2, B), eq', bus block (2, B), fre', fim').
    The inputs are not written. With the tracks sharded, ``psum`` sums
    the send bus and the dry mix over the ranks, in one call."""
    y, eq2 = iir_cascade(x, coeffs, eq_states)
    bus = torch.einsum("t,tb->b", send, y)
    dry = torch.einsum("ct,tb->cb", pan2, y)
    if psum is not None:
        both = psum(torch.cat([bus[None], dry]))
        bus, dry = both[0], both[1:]
    xbus = torch.stack([bus, bus])
    rev, fre2, fim2 = partconv_block(xbus, prev, fre, fim, h_re, h_im)
    mix = dry + WET_GAIN * rev
    return mix, eq2, xbus, fre2, fim2


class DAWSessionMixBenchmark(StandardBufferBenchmark):
    name = "DAWSessionMix"
    tolerance = 1e-3  # relative-to-peak, the FFT-convolution class

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA

    def setup(self) -> None:
        cfg = self.cfg
        check_full_fp32(self.name)
        self.eq_stages = cfg.session_eq_stages
        self.ir_length = cfg.ir_length or DEFAULT_IR_LENGTH
        self.partitions = num_partitions(self.ir_length, self.buffer_size)
        self.setup_standard_buffers()

        # Console: staggered-cutoff EQ cascade + deterministic sends/pans.
        self.stage_coeffs = [
            biquad_lowpass_coefficients(0.25 - 0.0125 * k)
            for k in range(self.eq_stages)
        ]
        coeffs = np.array(self.stage_coeffs, np.float32)
        self._coeffs_dev = self.put_replicated(coeffs)
        self.send_np, self.pan2_np = session_mix_params(
            self.track_count, cfg.seed)
        self._send = self.put_spec(self.send_np, "dp")
        self._pan2 = self.put_spec(self.pan2_np, None, "dp")

        # Stereo reverb bus: 2-track partitioned convolution.
        self.ir = reverb_impulse_responses(2, self.ir_length, cfg.seed)
        self._h = partition_spectra(self.put_replicated(self.ir),
                                    self.buffer_size)

        t, b = self.track_count, self.buffer_size
        zero_eq = np.zeros((self.eq_stages, t, 2), np.float32)
        zero_fdl = np.zeros((2, self.partitions, b + 1), np.float32)
        self._invocations = 0
        self._set_state((zero_eq, np.zeros((2, b), np.float32), zero_fdl,
                         zero_fdl))
        self.track_alloc("irSpectra", sum(a.numel() * 4 for a in self._h))
        self.track_alloc("fdl", 2 * zero_fdl.nbytes)
        self.track_alloc("eqState", zero_eq.nbytes)
        self.iterate()

    def _set_state(self, state) -> None:
        """(eq, prev, fre, fim) as NumPy arrays -> the entry state on the
        device (``_timing``, for the device tier and the stream) and
        iterate's state, which is the same tensors (no block writes
        them); the EQ state's tracks (axis 1) sharded."""
        eq, *rest = (np.array(a, np.float32) for a in state)
        self._timing = (self.put_spec(eq, None, "dp"),
                        *(self.put_replicated(a) for a in rest))
        self._eq, self._prev, self._fre, self._fim = self._timing

    def load_state(self, state: Sequence[np.ndarray], invocations: int,
                   h: Optional[Sequence[np.ndarray]] = None) -> None:
        """Take a stream's (eq, prev, fre, fim) as NumPy arrays, the number
        of blocks it has run, and optionally the reverb's H planes; the
        next ``iterate`` continues from it."""
        want = [(self.eq_stages, self.track_count, 2),
                (2, self.buffer_size),
                (2, self.partitions, self.buffer_size + 1),
                (2, self.partitions, self.buffer_size + 1)]
        got = [tuple(np.shape(a)) for a in state]
        if got != want:
            raise ValueError(f"{self.name}: state shapes {got}, want {want}")
        if h is not None:
            self._h = tuple(self.put_replicated(np.array(a, np.float32))
                            for a in h)
        self._set_state(state)
        self._invocations = int(invocations)

    def _step(self, x, eq, prev, fre, fim):
        return session_block(x, self._coeffs_dev, eq, self._send,
                             self._pan2, prev, fre, fim, *self._h,
                             psum=self.dp_psum if self._mesh else None)

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        mix, self._eq, self._prev, self._fre, self._fim = self._step(
            x, self._eq, self._prev, self._fre, self._fim)
        self.host_output = dev.from_device(mix)  # whole on every rank
        self._invocations += 1

    def device_iterate(self) -> None:
        self._step(self._resident_input, *self._timing)

    def overlap_body(self):
        step = self._step

        def f(x, carry):
            mix, *carry = step(x, *carry)
            return mix, tuple(carry)

        return (f, self.overlap_blocks(),
                (self._eq, self._prev, self._fre, self._fim))

    def stream_body(self):
        step_fn = self._step

        def step(carry):
            x, state = carry
            mix, *state = step_fn(x, *state)
            return (x, tuple(state)), probe(mix)

        return step, (self._resident_input, self._timing)

    def _replay_clamp(self) -> int:
        settle_blocks = -(-_EQ_SETTLE_SAMPLES // self.buffer_size)
        return self.partitions + settle_blocks + 8

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":  # skip the replay entirely
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        golden = session_reference(
            self.host_input, self.stage_coeffs, self.send_np, self.pan2_np,
            self.ir, WET_GAIN, self._invocations,
            clamp=self._replay_clamp(),
        )
        self.golden = golden
        floor = float(np.abs(golden).max())
        return compare_rel(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        t, b = self.track_count, self.buffer_size
        n = t * b
        p, bins = self.partitions, b + 1
        nfft = 2 * b
        fft_flops = 2.5 * nfft * math.log2(nfft)
        return {
            # EQ cascade (9/sample/stage) + send reduction (2/sample)
            # + stereo reverb on the 2-track bus (fwd+inv FFT + 8-flop
            # complex MAC per partition bin) + pan matmul (4/sample)
            # + wet return add.
            "flops": int(9 * self.eq_stages * n + 2 * n
                         + 2 * (2 * fft_flops + 8 * p * bins)
                         + 4 * n + 4 * b),
            # x read + mix write + EQ state r/w + shift-form FDL r+w on
            # the 2-track bus (4 passes x 2 planes) + H read (2 planes);
            # the (2, B) bus/prev blocks ride along.
            "hbm_bytes": int(
                n * 4 + 2 * b * 4
                + 2 * self.eq_stages * t * 2 * 4
                + (4 + 2) * 2 * p * bins * 4
                + 4 * 2 * b * 4),
            "unit": "vpu",
        }

    def transfer_model(self):
        return {"h2d_bytes": self.total_elements() * 4,
                "d2h_bytes": 2 * self.buffer_size * 4}

    def bytes_processed(self) -> int:
        return (self.total_elements() + 2 * self.buffer_size) * 4

    def metadata(self):
        return {
            "eqStages": self.eq_stages,
            "irLength": self.ir_length,
            "partitions": self.partitions,
            "wetGain": WET_GAIN,
            "replayClamp": self._replay_clamp(),
            "impl": self._impl,
        }
