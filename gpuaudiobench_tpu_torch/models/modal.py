"""ModalFilterBank: phasor-rotation sinusoid bank.

PyTorch counterpart of ``gpuaudiobench_tpu/models/modal.py`` (the Metal
semantics, kernels_benchmark_staging.metal:121-162). Modes =
min(1024 * nTracks, 1M) with 8 float params each; per sample the complex
state rotates by e^{i*2*pi*freq} and amp*Re(state) accumulates into
output track (mode % outputTracks), outputTracks = min(nTracks, 32).
Relative tolerance 1e-4 against the float64-accumulated NumPy golden.

The host data is the reference's, generated from the same seeded
MT19937 stream in the same order, so both packages synthesize the same
bank from the same seed.

Under ``--dataParallel N`` each rank synthesizes its slice of the padded
modes, Mp / N from mode r * Mp / N, through the same kernel, and the
ranks' folded outputs are summed by one ``psum`` a block. The fold is
out[m % T_out], so a rank's slice is padded with zero-amplitude modes
(amplitude and state 0, unit rotation) at its head up to its first
mode's place in the fold, and at its tail to a multiple of T_out: its
local fold then lines up with the global one, and the kernel, which
takes only a T_out dividing its mode count, takes it. A zero-amplitude
mode adds exactly nothing; the psum changes only the order of the sum.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import (
    ValidationData,
    compare_rel,
)
from gpuaudiobench_tpu_torch.ops.modal import modal_bank, modal_folded_step
from gpuaudiobench_tpu_torch.utils import device as dev

NUM_MODE_PARAMS = 8
PARAM_NAMES = ("amp", "cos_w", "sin_w", "state_re", "state_im")


def _renorm_wrap(step, re0: torch.Tensor, im0: torch.Tensor):
    """Streaming-only magnitude renormalization (cfg.modal_renorm).

    The f32 phasor rotation is not exactly unitary, so round-off
    compounds over long streams, faithful to the reference, which never
    renormalizes. This wrapper rescales each mode's phasor back to its
    INITIAL magnitude after every block; the phase (the musical content)
    is untouched.
    """
    mag0 = torch.sqrt(re0 * re0 + im0 * im0)
    tiny = torch.tensor(1e-30, dtype=re0.dtype, device=re0.device)
    one = torch.tensor(1.0, dtype=re0.dtype, device=re0.device)

    def renorm_step(carry):
        carry2, out = step(carry)
        *consts, re, im = carry2
        mag = torch.sqrt(re * re + im * im)
        scale = torch.where(mag0 > 0, mag0 / torch.maximum(mag, tiny), one)
        return (*consts, re * scale, im * scale), out

    return renorm_step


def modal_reference(
    amp: np.ndarray,
    cos_w: np.ndarray,
    sin_w: np.ndarray,
    state_re: np.ndarray,
    state_im: np.ndarray,
    buffer_size: int,
    output_tracks: int,
) -> np.ndarray:
    """Float64-accumulated iterative golden
    (ModalFilterBankBenchmark.swift:73-101)."""
    m = amp.shape[0]
    re = state_re.astype(np.float32).copy()
    im = state_im.astype(np.float32).copy()
    out = np.zeros((output_tracks, buffer_size), np.float64)
    groups = m // output_tracks
    amp64 = amp.astype(np.float64)
    for n in range(buffer_size):
        new_re = re * cos_w - im * sin_w
        new_im = re * sin_w + im * cos_w
        re, im = new_re, new_im
        contrib = (amp64 * re).reshape(groups, output_tracks).sum(axis=0)
        out[:, n] = contrib
    return out.astype(np.float32)


def modal_reference_gs(
    amp: np.ndarray,
    cos_w: np.ndarray,
    sin_w: np.ndarray,
    state_re: np.ndarray,
    state_im: np.ndarray,
    buffer_size: int,
    output_tracks: int,
) -> np.ndarray:
    """Golden of the Gordon-Smith resonator form (``ops.modal.modal_bank``
    with ``algorithm="res"``): the same f32 shear sequence as the kernel
    (``res_init``, then q = q - eps*y, y = y + eps*q per sample),
    f64-accumulated. A golden of its own, because any recurrence other
    than the golden's own f32 operator drifts ~1e-4 relative by sample
    512 (phase quantization)."""
    m = amp.shape[0]
    f32 = np.float32
    ampf = amp.astype(f32)
    ch = np.sqrt(((1.0 + cos_w) * f32(0.5)).astype(f32)).astype(f32)
    sh = (sin_w / (f32(2.0) * ch)).astype(f32)
    eps = (f32(2.0) * sh).astype(f32)
    y = (ampf * state_re.astype(f32)).astype(f32)
    q = (sh * (ampf * state_re) - ch * (ampf * state_im)).astype(f32)
    out = np.zeros((output_tracks, buffer_size), np.float64)
    groups = m // output_tracks
    for n in range(buffer_size):
        q = (q - eps * y).astype(f32)
        y = (y + eps * q).astype(f32)
        out[:, n] = y.astype(np.float64).reshape(
            groups, output_tracks).sum(axis=0)
    return out.astype(np.float32)


def params_from_numpy(params: Dict[str, np.ndarray],
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """The reference benchmark's ``bench.params`` (float32 numpy arrays
    amp, cos_w, sin_w, state_re, state_im) as device tensors."""
    out = {}
    for k in PARAM_NAMES:
        a = params[k]
        if a.dtype != np.float32 or a.ndim != 1:
            raise ValueError(f"{k}: need 1-D float32, got {a.dtype} {a.shape}")
        out[k] = dev.to_device(a, device)
    return out


class ModalFilterBankBenchmark(Benchmark):
    name = "ModalFilterBank"
    tolerance = 1e-4  # relative (ModalFilterBankBenchmark.swift:167)

    def __init__(self, cfg: BenchConfig, device: torch.device):
        super().__init__(cfg, device)
        self.num_modes = cfg.modal_num_modes or min(1024 * cfg.n_tracks, 1024 * 1024)
        self.output_tracks = min(cfg.n_tracks, 32)
        # Pad with zero-amplitude modes so modes fold evenly onto tracks.
        self.padded_modes = -(-self.num_modes // self.output_tracks) * self.output_tracks
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA

    def setup(self) -> None:
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        m, mp = self.num_modes, self.padded_modes
        self.setup_sharding(mp, "modes (padded)")
        amp = np.zeros(mp, np.float32)
        freq = np.zeros(mp, np.float32)
        self.phase = np.zeros(mp, np.float32)  # generated but unused (Metal parity)
        sre = np.zeros(mp, np.float32)
        sim = np.zeros(mp, np.float32)
        amp[:m] = g.random(m, dtype=np.float32)  # amp in [0,1)
        freq[:m] = g.random(m, dtype=np.float32) * 0.45  # freq in [0,0.45)
        self.phase[:m] = g.random(m, dtype=np.float32) * np.float32(2 * np.pi)
        sre[:m] = g.random(m, dtype=np.float32) * 2 - 1
        sim[:m] = g.random(m, dtype=np.float32) * 2 - 1

        w = (np.float32(2 * np.pi) * freq).astype(np.float32)
        cos_w = np.cos(w).astype(np.float32)
        sin_w = np.sin(w).astype(np.float32)
        self.load_params({
            "amp": amp, "cos_w": cos_w, "sin_w": sin_w,
            "state_re": sre, "state_im": sim,
        })

    def load_params(self, params: Dict[str, np.ndarray]) -> None:
        """Place the mode tables on the device, compute the golden and run
        one iteration. ``setup`` calls it with the seeded tables; tests
        call it with the reference benchmark's ``params``."""
        if params["amp"].shape != (self.padded_modes,):
            raise ValueError(
                f"expected {self.padded_modes} modes, got "
                f"{params['amp'].shape}")
        self.params = params
        self._dev = params_from_numpy(self._local_modes(params), self.device)
        self.track_alloc("modeParams", self.num_modes * NUM_MODE_PARAMS * 4)
        self.track_alloc("outputBuffer", self.output_tracks * self.buffer_size * 4)
        # The golden iterates the full bank on the host, so skip it when
        # validation is off.
        self.golden = None
        if self.cfg.verification != "none":
            self.golden = modal_reference(
                *(params[k] for k in PARAM_NAMES),
                self.buffer_size, self.output_tracks,
            )
        self.host_output = None
        self.iterate()

    def _local_modes(self, params: Dict[str, np.ndarray]):
        """This rank's slice of the mode tables, padded with zero-amplitude
        modes to line up with the global fold (the tables themselves when
        unsharded)."""
        if self._mesh is None:
            return params
        part = self.dp_slice(self.padded_modes)
        head = part.start % self.output_tracks
        tail = -(head + part.stop - part.start) % self.output_tracks
        fill = {"cos_w": 1.0}  # a unit rotation; everything else 0
        return {k: np.concatenate([
            np.full(head, fill.get(k, 0.0), np.float32), params[k][part],
            np.full(tail, fill.get(k, 0.0), np.float32)])
            for k in PARAM_NAMES}

    def _run(self):
        # The wrapper launches the kernel on CUDA tensors; only CPU
        # tensors take its plain twin.
        d = self._dev
        out, re, im = modal_bank(d["amp"], d["cos_w"], d["sin_w"],
                                 d["state_re"], d["state_im"],
                                 self.buffer_size, self.output_tracks)
        return self.dp_psum(out), re, im

    def iterate(self) -> None:
        # Mode params stay on the device across iterations (Metal
        # unified-memory parity); the measured round trip is launch +
        # output readback.
        out, _, _ = self._run()
        self.host_output = dev.from_device(out)

    def device_iterate(self) -> None:
        self._run()

    def stream_body(self):
        # Streaming synthesis carries the ROTATED, amp-prefolded phasor
        # states across blocks through the folded step (modal_bank's
        # contract returns its input states unchanged). The kernel masks
        # its own ragged edge, so the mode axis needs no padding beyond
        # the fold's multiple of T_out and the stream synthesizes exactly
        # padded_modes.
        d, s, t = self._dev, self.buffer_size, self.output_tracks
        re0 = d["amp"] * d["state_re"]
        im0 = d["amp"] * d["state_im"]
        psum = self.dp_psum

        def step(carry):
            cos_c, sin_c, re, im = carry
            out_sn, re2, im2 = modal_folded_step(cos_c, sin_c, re, im, s, t)
            return (cos_c, sin_c, re2, im2), probe(psum(out_sn))

        if self.cfg.modal_renorm:
            step = _renorm_wrap(step, re0, im0)
        return step, (d["cos_w"], d["sin_w"], re0, im0)

    def validate(self) -> ValidationData:
        if self.golden is None:  # verification == "none" (no golden)
            return compare_rel(
                self.host_output, self.host_output, self.tolerance,
                mode="none", label=self.name,
            )
        # Relative-to-peak metric (error <= tol * max|golden|): summing
        # thousands of f32 mode contributions carries ~1e-5-relative-to-
        # peak rounding regardless of implementation, and a per-sample
        # relative check is unbounded where the bank cancels.
        floor = float(np.abs(self.golden).max())
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        m, s = self.padded_modes, self.buffer_size
        return {
            "flops": 8 * m * s,  # 6 rotate + 2 accumulate
            "hbm_bytes": (4 * m + 2 * m + s * self.output_tracks) * 4,
            "unit": "vpu",
        }

    def total_elements(self) -> int:
        return self.buffer_size * self.output_tracks

    def bytes_processed(self) -> int:
        # mode params in + output out (Metal buffer sizes)
        return self.num_modes * NUM_MODE_PARAMS * 4 + self.total_elements() * 4

    def metadata(self):
        return {
            "numModes": self.num_modes,
            "outputTracks": self.output_tracks,
            "numModeParams": NUM_MODE_PARAMS,
            "impl": self._impl,
        }

    def transfer_model(self):
        """Mode params and phasor state stay on the device; the round
        trip is launch + output readback only."""
        return {"h2d_bytes": 0,
                "d2h_bytes": self.track_count * self.buffer_size * 4}
