"""RndMemRead: granular-synthesis random-memory stress
(cuda/bench_rndmem.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/rndmem.py``. A
uniform [0, 1) sample pool (512 MiB by default, ``--poolMiB``) stays on
the device from setup. Per iteration each track copies bufferSize
contiguous samples from its playhead into an interleaved (S, T) output
(out[tracks*i + track]) through the hand-written CUDA gather
(``ops.rndmem.rndmem_gather``); the playheads then advance on the host by
bufferSize, wrapping from a track's loop end back to its start (loop
lengths 1000-48000, bench_rndmem.cu:151-186). The stream body advances
them on the device instead. The overlapped-infeed tier uploads a block's
playheads while the last block's gather runs (``overlap_body``).

Validation gathers the golden with the playheads the last iteration used,
at 1e-6 absolute (bench_rndmem.cu:106), as the JAX benchmark does.

Under ``--dataParallel`` the pool is replicated on every rank and the
playheads and the output's track axis are sharded.

The pool carries no ``POOL_PAD``: the JAX package pads its device pool
only because the Pallas kernel fetches whole tile-rounded rows past the
window. The port's kernel reads the window alone (and clamps the start,
as XLA's ``dynamic_slice`` does).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.ops.rndmem import rndmem_gather
from gpuaudiobench_tpu_torch.utils.data import generate_uniform01


def rndmem_cost(tracks: int, samples: int) -> dict:
    """A block's cost: every output sample read once from the pool and
    written once, and the int32 playheads read; no arithmetic. The
    reference's count (``gpuaudiobench_tpu/models/rndmem.py:146``) leaves
    the playheads out. ``chip_smoke.py``'s bound reads this count too."""
    n = tracks * samples
    return {
        "flops": 0,
        "hbm_bytes": 2 * n * 4 + 4 * tracks,
        "unit": "vpu",
        "note": "random unaligned reads from a 512 MiB pool",
    }


class RndMemBenchmark(Benchmark):
    name = "RndMemRead"
    tolerance = 1e-6  # bench_rndmem.cu:106

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self.resolve_impl()  # raises for impl xla on CUDA
        self.pool_elems = cfg.rndmem_pool_mb * 1024 * 1024 // 4
        self.sample_buffer_end = self.pool_elems - cfg.buffer_size

    def setup(self) -> None:
        t = self.track_count
        self.setup_sharding(t)
        pool = generate_uniform01(self.pool_elems, self.cfg.seed)
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        starts = g.integers(0, self.sample_buffer_end, t)
        loop_lens = self.cfg.rndmem_min_loop + g.integers(
            0, self.cfg.rndmem_max_loop - self.cfg.rndmem_min_loop, t)
        ends = np.minimum(starts + loop_lens, self.sample_buffer_end - 1)
        self.load_state(pool, starts, ends, starts)

    def load_state(self, pool: np.ndarray, starts: np.ndarray,
                   ends: np.ndarray, playheads: np.ndarray) -> None:
        """Take the pool, the per-track loop starts and ends and the
        current playheads (e.g. a JAX benchmark's ``host_pool``,
        ``playheads_start``, ``playheads_end`` and ``playheads``), place
        the pool on the device and run one iteration. ``setup`` calls it
        with the seeded pool and draws."""
        t = self.track_count
        if pool.dtype != np.float32 or pool.ndim != 1 or pool.size < self.buffer_size:
            raise ValueError(f"{self.name}: need a float32 pool of at least "
                             f"{self.buffer_size} samples, got {pool.dtype} "
                             f"{pool.shape}")
        for label, a in (("starts", starts), ("ends", ends),
                         ("playheads", playheads)):
            if np.shape(a) != (t,):
                raise ValueError(f"{self.name}: {label} must be ({t},), got "
                                 f"{np.shape(a)}")
        self.host_pool = pool
        self._pool_dev = self.put_replicated(pool)
        self.track_alloc("samplePool", pool.nbytes * 2)  # host + device
        self.track_alloc("outputBuffer", t * self.buffer_size * 4 * 2)
        self.playheads_start = np.asarray(starts).astype(np.int64)
        self.playheads_end = np.asarray(ends).astype(np.int64)
        self.playheads = np.asarray(playheads).astype(np.int32)
        self.last_playheads = self.playheads.copy()
        self.host_output = None
        self.iterate()

    def iterate(self) -> None:
        self._ph_dev = self.put_sharded(self.playheads)
        out = rndmem_gather(self._pool_dev, self._ph_dev, self.buffer_size)
        # (S, T) interleaved, gathered along its track axis.
        self.host_output = self.to_host(out, axis=1).ravel()
        self.last_playheads = self.playheads.copy()
        self._update_playheads()

    def _update_playheads(self) -> None:
        """Host-side playhead advance with loop wrap (bench_rndmem.cu:176-186)."""
        ph = self.playheads.astype(np.int64) + self.buffer_size
        wrapped = np.where(ph >= self.playheads_end, self.playheads_start, ph)
        self.playheads = wrapped.astype(np.int32)

    def overlap_body(self):
        """The per-block host traffic here is the playhead array (the
        reference advances the playheads on the host every iteration,
        bench_rndmem.cu:176-186): the overlap tier uploads block k+1's
        playheads while block k's gather runs. The two host blocks are
        this block's playheads and the next's."""
        pool, s = self._pool_dev, self.buffer_size
        ph1 = self.playheads.copy()
        ph2 = self.playheads.astype(np.int64) + s
        ph2 = np.where(ph2 >= self.playheads_end, self.playheads_start,
                       ph2).astype(np.int32)
        return (lambda ph, c: (rndmem_gather(pool, ph, s), c),
                [ph1, ph2], ())

    def device_iterate(self) -> None:
        # The last iteration's playheads, already on the device.
        rndmem_gather(self._pool_dev, self._ph_dev, self.buffer_size)

    def stream_body(self):
        pool, s = self._pool_dev, self.buffer_size
        starts = self.put_sharded(self.playheads_start)
        ends = self.put_sharded(self.playheads_end)

        def step(ph):
            out = rndmem_gather(pool, ph, s)
            ph2 = ph.to(torch.int64) + s  # _update_playheads, on the device
            ph2 = torch.where(ph2 >= ends, starts, ph2).to(torch.int32)
            return ph2, probe(out)

        return step, self.put_sharded(self.playheads)

    def validate(self) -> ValidationData:
        s = self.buffer_size
        idx = self.last_playheads[:, None].astype(np.int64) + np.arange(s)[None, :]
        golden = self.host_pool[idx].T.ravel()  # (S, T) interleaved
        return compare_abs(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        return rndmem_cost(self.track_count, self.buffer_size)

    def metadata(self):
        return {
            "poolMiB": self.cfg.rndmem_pool_mb,
            "minLoopLen": self.cfg.rndmem_min_loop,
            "maxLoopLen": self.cfg.rndmem_max_loop,
        }

    def transfer_model(self):
        """The pool stays on the device; per block only the int32
        playheads go up and the interleaved output comes down."""
        return {"h2d_bytes": self.track_count * 4,
                "d2h_bytes": self.track_count * self.buffer_size * 4}
