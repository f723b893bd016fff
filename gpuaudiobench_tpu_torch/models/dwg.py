"""DWG1DNaive / DWG1DAccel: digital-waveguide strings (cuda/bench_dwg.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/dwg.py``. nTracks
waveguides with delay-line rails of pitch dwg_max_length (2000) and
lengths drawn from [dwg_min_length, dwg_max_length) (100-2000), taps at
L/4 and 3L/4, gain 0.1 + 0.9u, reflection 0.99 +- 0.005, damping
0.9999 +- 5e-5, seed 42, from the JAX benchmark's MT19937 stream; the
mono bufferSize output is summed over all waveguides. DWG1DAccel rounds
the lengths down to powers of two. After the draws the waveguides are
stably partitioned by L >= bufferSize, as the JAX benchmark does for its
arc kernel, so the rows line up with its rows.

Every ``iterate()`` uploads the input and the evolved rails, runs the
hand-written CUDA kernel (``ops.dwg.dwg_block``) on them in place and
reads the output and both rails back in one copy (the reference moves
the rails both ways every iteration, bench_dwg.cu:203-247), so the
strings ring across blocks. Validation replays the float32 NumPy golden
``dwg_reference`` once per performed iteration from the starting rails
and compares the last block's output and both rails at 1e-2 absolute
(bench_dwg.cu:270).

The output is structurally zero (each sample touches one closed cell
pair, and the in-tap pair never reaches the out-tap pair; see the JAX
module), so the rails carry the evidence. The stream carries the plain
rails (fwd, bwd); the JAX package's Pallas stream carries its arc
kernel's aligned form instead.

Under ``--dataParallel`` each rank holds its waveguides (parameters and
rails, after the partition) and the whole input block, runs the kernel
on them, and one ``psum`` a block sums the ranks' mono outputs. The
rails stay sharded and are read back whole, in the same one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.ops.dwg import dwg_block

REFLECTION = 0.99
DAMPING = 0.9999
MIX_FACTOR = 0.5  # benchmark_constants.cuh WAVEGUIDE_MIX_FACTOR


def dwg_reference(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp):
    """Float32 one-block golden, vectorized over waveguides
    (bench_dwg.cu:356-399); returns (out, fwd', bwd'), so repeated calls
    reproduce the carried rails."""
    fwd = fwd.copy()
    bwd = bwd.copy()
    g = fwd.shape[0]
    rows = np.arange(g)
    half = lengths // 2
    out = np.zeros(x.shape[0], np.float32)
    for n in range(x.shape[0]):
        cur = n % lengths
        bpos = (cur + half) % lengths
        f = fwd[rows, cur] * damp
        b = bwd[rows, bpos] * damp
        inj = np.where(cur == in_taps, np.float32(x[n]) * gains, np.float32(0))
        f = f + inj
        b = b + inj
        fwd[rows, cur] = b * refl
        bwd[rows, bpos] = f * refl
        out[n] = np.sum(
            np.where(cur == out_taps, (f + b) * np.float32(MIX_FACTOR), np.float32(0))
        )
    return out, fwd, bwd


def dwg_cost(waveguides: int, samples: int, touched: int) -> dict:
    """A block's cost. ``touched`` is the number of rail cell pairs the
    block reaches, sum over waveguides of min(L, S): each fwd and bwd cell
    of them read and written once (16 B a pair), x read and out written
    (8 B a sample), 24 B of parameters a waveguide; 10 FLOP a waveguide
    and sample. The reference's count (``gpuaudiobench_tpu/models/
    dwg.py:314``) moves 32 B a touched pair and no parameters.
    ``chip_smoke.py``'s bound reads this count too."""
    return {
        "flops": 10 * waveguides * samples,
        "hbm_bytes": 16 * touched + 8 * samples + 24 * waveguides,
        "unit": "vpu",
    }


PARAMS = ("lengths", "in_taps", "out_taps", "gains", "refl", "damp")


class DWGBenchmark(Benchmark):
    name = "DWG1DNaive"
    tolerance = 1e-2  # bench_dwg.cu:270

    def __init__(self, cfg, device: torch.device, accelerated: bool = False):
        super().__init__(cfg, device)
        self.resolve_impl()  # raises for impl xla on CUDA
        self.accelerated = accelerated
        if accelerated:
            self.name = "DWG1DAccel"
        self._max_len = cfg.dwg_max_length

    def setup(self) -> None:
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        n_wg = self.track_count
        lo, hi = self.cfg.dwg_min_length, self.cfg.dwg_max_length
        lengths = lo + g.integers(0, max(1, hi - lo), n_wg)
        if self.accelerated:
            lengths = (2 ** np.floor(np.log2(lengths))).astype(np.int64)
        lengths = lengths.astype(np.int32)
        params = {
            "lengths": lengths,
            "in_taps": (lengths // 4).astype(np.int32),
            "out_taps": (3 * lengths // 4).astype(np.int32),
            "gains": (0.1 + 0.9 * g.random(n_wg, dtype=np.float32)).astype(np.float32),
            "refl": (REFLECTION + 0.01 * (g.random(n_wg, dtype=np.float32) - 0.5)
                     ).astype(np.float32),
            "damp": (DAMPING + 0.0001 * (g.random(n_wg, dtype=np.float32) - 0.5)
                     ).astype(np.float32),
        }
        host_input = (g.random(self.buffer_size, dtype=np.float32) * 2 - 1
                      ).astype(np.float32)
        # Stable partition: waveguides with L >= bufferSize first, after
        # all draws, as the JAX benchmark orders its rows.
        order = np.argsort(lengths < self.buffer_size, kind="stable")
        params = {k: v[order] for k, v in params.items()}
        self.setup_sharding(n_wg, "waveguides (nTracks)")
        zero = np.zeros((n_wg, self._max_len), np.float32)
        self.load_state(host_input, params, zero, zero)

    def load_state(self, host_input: np.ndarray, params, fwd: np.ndarray,
                   bwd: np.ndarray) -> None:
        """Take the input block, the per-waveguide parameters (a dict of
        ``PARAMS``, e.g. a JAX benchmark's attributes of those names) and
        the carried rails (e.g. its ``host_fwd``, ``host_bwd``), place them
        on the device and run one iteration. The golden replays from these
        rails. ``setup`` calls it with the seeded data and silent rails."""
        n_wg = self.track_count
        shape = (n_wg, self._max_len)
        if fwd.shape != shape or bwd.shape != shape:
            raise ValueError(f"{self.name}: rails must be {shape}, got "
                             f"{fwd.shape} {bwd.shape}")
        if host_input.shape != (self.buffer_size,):
            raise ValueError(f"{self.name}: input must be "
                             f"({self.buffer_size},), got {host_input.shape}")
        lengths = np.asarray(params["lengths"])
        if lengths.shape != (n_wg,) or lengths.min() < 1 or lengths.max() > self._max_len:
            raise ValueError(f"{self.name}: lengths must be ({n_wg},) in "
                             f"[1, {self._max_len}]")
        for k in PARAMS:
            dtype = np.int32 if k in ("lengths", "in_taps", "out_taps") else np.float32
            setattr(self, k, np.asarray(params[k]).astype(dtype))
        self.host_input = np.asarray(host_input, np.float32)
        self._start_fwd = np.array(fwd, np.float32)
        self._start_bwd = np.array(bwd, np.float32)
        self.host_fwd = self._start_fwd
        self.host_bwd = self._start_bwd
        self.track_alloc("delayRails", fwd.nbytes * 4)  # fwd+bwd, host+dev
        self.track_alloc("ioBuffers", self.buffer_size * 4 * 4)
        self._consts = [self.put_sharded(getattr(self, k)) for k in PARAMS]
        self._resident_input = self.put_replicated(self.host_input)
        # Rails for the device tier, updated in place run after run.
        self._timing_rails = (self.put_sharded(self._start_fwd),
                              self.put_sharded(self._start_bwd))
        self.host_output = None
        self._invocations = 0
        self.iterate()

    def _run(self, x, fwd, bwd):
        out, fwd, bwd = dwg_block(x, fwd, bwd, *self._consts)
        return self.dp_psum(out), fwd, bwd

    def iterate(self) -> None:
        x = self.put_replicated(self.host_input)
        fwd = self.put_sharded(self.host_fwd)
        bwd = self.put_sharded(self.host_bwd)
        out, fwd, bwd = self._run(x, fwd, bwd)
        self.host_output, self.host_fwd, self.host_bwd = self.to_host_parts(
            [(out, None), (fwd, 0), (bwd, 0)])
        self._invocations += 1

    def device_iterate(self) -> None:
        self._run(self._resident_input, *self._timing_rails)

    def stream_body(self):
        run = self._run

        def step(carry):
            x, fwd, bwd = carry
            out, fwd, bwd = run(x, fwd, bwd)
            return (x, fwd, bwd), probe(out)

        return step, (self._resident_input, self.put_sharded(self.host_fwd),
                      self.put_sharded(self.host_bwd))

    def overlap_body(self):
        """Input upload double-buffered against the rail update; the
        rails carry on the device (updated in place), from the last
        round trip's."""
        run = self._run

        def step(x, rails):
            out, fwd, bwd = run(x, *rails)
            return out, (fwd, bwd)

        return (step, [self.host_input, np.negative(self.host_input)],
                (self.put_sharded(self.host_fwd),
                 self.put_sharded(self.host_bwd)))

    def validate(self) -> ValidationData:
        if self.cfg.verification == "none":
            return compare_abs(self.host_output, self.host_output,
                               self.tolerance, mode="none", label=self.name)
        fwd, bwd = self._start_fwd, self._start_bwd
        golden = None
        for _ in range(self._invocations):
            golden, fwd, bwd = dwg_reference(
                self.host_input, fwd, bwd, self.lengths, self.in_taps,
                self.out_taps, self.gains, self.refl, self.damp)
        self.golden, self.golden_fwd, self.golden_bwd = golden, fwd, bwd
        v = compare_abs(self.host_output, golden, self.tolerance,
                        mode=self.cfg.verification,
                        limit=self.cfg.spot_sample_limit, label=self.name)
        for label, got, want in (("fwd rail", self.host_fwd, fwd),
                                 ("bwd rail", self.host_bwd, bwd)):
            v.merge_failure(compare_abs(
                got, want, self.tolerance, mode=self.cfg.verification,
                limit=self.cfg.spot_sample_limit, label=f"{self.name} {label}"))
        return v

    def cost_model(self):
        touched = int(np.minimum(self.lengths, self.buffer_size).sum())
        return dwg_cost(self.track_count, self.buffer_size, touched)

    def bytes_processed(self) -> int:
        # input + mono output + both rails in each direction
        rails = 2 * self.track_count * self._max_len * 4
        return self.buffer_size * 4 * 2 + 2 * rails

    def metadata(self):
        return {
            "numWaveguides": self.track_count,
            "maxLength": self._max_len,
            "variant": "accel" if self.accelerated else "naive",
        }
