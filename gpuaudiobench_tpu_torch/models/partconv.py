"""PartConv: uniformly partitioned overlap-save streaming convolution
(convolution reverb), an extension benchmark.

PyTorch counterpart of ``gpuaudiobench_tpu/models/partconv.py``. A long
(default 1 s = 48,000-tap) IR per track streams through a
frequency-domain delay line (``ops/partconv.py``): the shift form (the
default), the ring form, or the two-level nupols form
(``--partconvForm``), with the IR spectra stored in f32 or f16
(``--partconvHDtype``). The delay line and the previous input block stay
on the device across iterations; each round trip uploads the block and
reads the output block back.

The ring and nupols blocks write their delay-line slots in place, so
every tier owns its state: ``iterate`` its own; the device tier a copy
of the entry state made at set-up (``_device_state``), which it rewrites
with the same values on every call; the stream and the overlap pass a
copy made when they ask for their body. The entry state itself
(``_timing_state``) is never written. The ring head and the nupols phase
are Python ints.

Validation is the reference's closed-form fold-algebra golden in f64
(``partconv_reference``), structurally independent of the partitioned
FFT path, relative to the golden's peak at 1e-3 (the Conv1D_accel FFT
class, bench_conv1d_accel.cu:310). ``load_state`` takes a JAX stream's
state (NumPy leaves) and its block count, so the two packages can be run
from one mid-stream state.

Under ``--dataParallel`` each rank holds its tracks: their IRs' spectra
and every track-major leaf of the state; the ring head and the nupols
phase are the same on every rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_rel
from gpuaudiobench_tpu_torch.models.common import StandardBufferBenchmark
from gpuaudiobench_tpu_torch.ops.partconv import (
    clone_state,
    make_partconv_block_nupols,
    num_partitions,
    nupols_init_state,
    nupols_spectra,
    nupols_tail_partitions,
    partconv_block,
    partconv_block_ring,
    partition_spectra,
    ring_aligned_spectra,
    state_to_device,
)
from gpuaudiobench_tpu_torch.utils.data import reverb_impulse_responses

DEFAULT_IR_LENGTH = 48000  # 1.0 s at the default 48 kHz


def partconv_reference(x: np.ndarray, ir: np.ndarray, k: int,
                       block_size: int) -> np.ndarray:
    """Float64 output block k (1-indexed) of the streaming convolution of
    the k-times-repeated block x with ir: the B-periodic convolution of x
    with the sum of partitions 0..k-2, plus the head of the linear
    convolution with partition k-1 (absent once k > P)."""
    t, b = x.shape
    length = ir.shape[1]
    p = num_partitions(length, b)
    parts = np.zeros((t, p * b), np.float64)
    parts[:, :length] = ir.astype(np.float64)
    parts = parts.reshape(t, p, b)
    x64 = x.astype(np.float64)

    n_folded = min(k - 1, p)
    fold = parts[:, :n_folded].sum(axis=1) if n_folded else np.zeros(
        (t, b), np.float64)
    y = np.fft.irfft(np.fft.rfft(x64, axis=1) * np.fft.rfft(fold, axis=1),
                     b, axis=1)
    if k <= p:
        tail = parts[:, k - 1]
        y += np.fft.irfft(
            np.fft.rfft(x64, 2 * b, axis=1)
            * np.fft.rfft(tail, 2 * b, axis=1), 2 * b, axis=1)[:, :b]
    return y.astype(np.float32)


class PartConvBenchmark(StandardBufferBenchmark):
    name = "PartConv"
    tolerance = 1e-3  # relative-to-peak, the FFT-convolution class

    def setup(self) -> None:
        cfg = self.cfg
        self.ir_length = cfg.ir_length or DEFAULT_IR_LENGTH
        self.partitions = num_partitions(self.ir_length, self.buffer_size)
        self.setup_standard_buffers()
        self.ir = reverb_impulse_responses(
            self.track_count, self.ir_length, cfg.seed)

        form = cfg.partconv_form
        self.nupols_tail = 0
        if form == "nupols":
            self.nupols_tail = nupols_tail_partitions(
                self.ir_length, self.buffer_size, cfg.partconv_tail_chunk)
            if self.nupols_tail == 0:
                # The K-slot head covers the whole IR: run the exact-P
                # shift form and say so in the metadata.
                form = "shift"
        self._form = form

        t, b = self.track_count, self.buffer_size
        ir_dev = self.put_sharded(self.ir)
        if form == "nupols":
            k, m = cfg.partconv_tail_chunk, self.nupols_tail
            (hh_re, hh_im), (ht_re, ht_im) = nupols_spectra(ir_dev, b, k)
            h = (hh_re, hh_im, ht_re, ht_im)
            block = make_partconv_block_nupols(b, k, m)
            self._block = lambda x, state, hs: block(x, state, *hs)
            state_np = nupols_init_state(t, b, k, m)
            # Head FDL planes + the doubled tail ring (2M slots a plane),
            # from the allocated leaves.
            fdl_bytes = sum(state_np[i].nbytes for i in (1, 2, 9, 10))
        else:
            h = partition_spectra(ir_dev, b)
            if form == "ring":
                h = ring_aligned_spectra(*h)
                self._block = _ring_block
            else:
                self._block = _shift_block
            zeros_fdl = np.zeros((t, self.partitions, b + 1), np.float32)
            # The ring's first block writes slot 0; the shift form carries
            # the head untouched.
            state_np = (np.zeros((t, b), np.float32), self.partitions - 1,
                        zeros_fdl, zeros_fdl)
            fdl_bytes = 2 * zeros_fdl.nbytes
        del ir_dev
        if cfg.partconv_h_dtype == "f16":
            # The reference measured 1.9e-4 of the peak against the 1e-3
            # contract at the default shape; it halves the H read.
            h = tuple(a.to(torch.float16) for a in h)
        self._h = h
        self._invocations = 0
        self._set_state(self._state_to_device(state_np))
        self.track_alloc("irSpectra", self.dp_ranks * sum(
            a.numel() * a.element_size() for a in self._h))
        self._fdl_bytes = fdl_bytes
        self.track_alloc("fdl", fdl_bytes)
        self.iterate()

    def _state_to_device(self, state):
        """A state of NumPy leaves and ints on the device, each array this
        rank's tracks (axis 0)."""
        return state_to_device(tuple(self.shard(np.asarray(a)) if np.ndim(a)
                                     else a for a in state), self.device)

    def _set_state(self, state) -> None:
        """``state`` becomes the entry state (never written) and, as
        copies, iterate's state and the device tier's."""
        self._timing_state = state
        self._state = clone_state(state)
        self._device_state = clone_state(state)

    def load_state(self, state: Sequence, invocations: int,
                   h: Optional[Sequence[np.ndarray]] = None) -> None:
        """Take a stream's state as NumPy arrays in the reference's order
        (shift/ring ``(prev, head, fdl_re, fdl_im)``, nupols the 14 leaves
        of ``nupols_init_state``), the number of blocks it has run, and
        optionally the H planes (the reference's ``_h``, in their dtype).
        The next ``iterate`` continues from it; the golden counts from
        ``invocations``."""
        want = 14 if self._form == "nupols" else 4
        if len(state) != want:
            raise ValueError(f"{self.name}: the {self._form} form's state has "
                             f"{want} leaves, got {len(state)}")
        if h is not None:
            if len(h) != len(self._h):
                raise ValueError(f"{self.name}: need {len(self._h)} H planes")
            self._h = tuple(self.put_sharded(np.array(a)) for a in h)
        self._set_state(self._state_to_device(state))
        self._invocations = int(invocations)

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y, self._state = self._block(x, self._state, self._h)
        self.host_output = self.to_host(y)
        self._invocations += 1

    def device_iterate(self) -> None:
        self._block(self._resident_input, self._device_state, self._h)

    def overlap_body(self):
        """From a copy of iterate's state. The block carries its input as
        the next block's ``prev``, and the overlap tier refills an input
        slot once the block that read it as ``x`` is done, not the next
        one, which reads it as ``prev``: so the block takes a copy."""
        block, h = self._block, self._h
        return ((lambda x, state: block(x.clone(), state, h)),
                self.overlap_blocks(), clone_state(self._state))

    def stream_body(self):
        block, h = self._block, self._h

        def step(carry):
            x, state = carry
            y, state = block(x, state, h)
            return (x, state), probe(y)

        return step, (self._resident_input, clone_state(self._timing_state))

    def cost_model(self):
        t, b = self.track_count, self.buffer_size
        p, bins = self.partitions, b + 1
        if not hasattr(self, "_form"):  # pre-setup (tests poke shapes)
            self._form = self.cfg.partconv_form
        n = 2 * b
        fft_flops = 2.5 * n * math.log2(n)  # real-FFT flop model
        hdt = 2 if self.cfg.partconv_h_dtype == "f16" else 4
        if self._form == "nupols":
            k = self.cfg.partconv_tail_chunk
            m = self.nupols_tail
            kbins = k * b + 1
            nk = 2 * k * b
            fft_k = 2.5 * nk * math.log2(nk)
            return {
                # Head = K-slot uniform shift; tail FFTs + MAC + FDL
                # push amortized over the K-block window; the spread
                # accumulator adds per block.
                "flops": int(t * (2 * fft_flops + 8 * k * bins
                                  + (2 * fft_k + 8 * m * kbins) / k
                                  + 2 * kbins)),
                # Head FDL r+w + H read; tail per fire (/K): MAC FDL
                # read (8 B/bin) + H read (2*hdt); every block: the
                # idempotent ring write (2 slots x 2 planes = 16 B/bin,
                # M-independent) + acc r+w (16 B/bin).
                "hbm_bytes": int(
                    t * (4 * k * bins * 4 + 2 * k * bins * hdt
                         + (8 + 2 * hdt) * m * kbins / k
                         + 32 * kbins + 2 * b * 4)),
                "unit": "vpu",
            }
        return {
            # forward + inverse FFT, plus the 8-flop complex MAC per
            # (partition, bin).
            "flops": int(t * (2 * fft_flops + 8 * p * bins)),
            # Ring form: one FDL read + one contiguous H2-window read
            # (P slots of the doubled spectra) per block, two planes
            # each (FDL f32; H f32 or f16); the one-slot write and the
            # x/y block traffic ride along. The shift form adds a full
            # FDL rewrite.
            "hbm_bytes": (
                (2 if self._form == "ring" else 4)
                * t * p * bins * 4         # FDL read (+rewrite if shift)
                + 2 * t * p * bins * hdt   # H
                + 2 * t * b * 4),
            "unit": "vpu",
        }

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":  # skip the golden entirely
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        golden = partconv_reference(
            self.host_input, self.ir, self._invocations, self.buffer_size)
        self.golden = golden
        floor = float(np.abs(golden).max())
        return compare_rel(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def metadata(self):
        md = {
            "irLength": self.ir_length,
            "form": self.cfg.partconv_form,
            "formResolved": self._form,  # nupols falls back to shift
            #                              when the head covers the IR
            "hDtype": self.cfg.partconv_h_dtype,
            "partitions": self.partitions,
            "fftSize": 2 * self.buffer_size,
            "fdlBytes": self._fdl_bytes,
        }
        if self._form == "nupols":
            k = self.cfg.partconv_tail_chunk
            md.update({
                "nupolsTailChunk": k,
                "nupolsHeadPartitions": k,
                "nupolsTailPartitions": self.nupols_tail,
                "nupolsTailFftSize": 2 * k * self.buffer_size,
            })
        return md


def _shift_block(x, state, h):
    prev, head, fre, fim = state
    y, fre, fim = partconv_block(x, prev, fre, fim, *h)
    return y, (x, head, fre, fim)


def _ring_block(x, state, h):
    prev, head, fre, fim = state
    y, head, fre, fim = partconv_block_ring(x, prev, head, fre, fim, *h)
    return y, (x, head, fre, fim)
