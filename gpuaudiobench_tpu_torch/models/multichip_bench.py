"""The registered multi-device benchmarks: MultiChipSuite and
ICIBandwidth.

PyTorch counterpart of ``gpuaudiobench_tpu/models/multichip_bench.py``:

* ``MultiChipSuite``: the sharded audio pipeline of
  ``parallel/multichip.py`` (dp tracks, tp modes and psum, sp samples and
  halo, the pp cascade) over a ``--mesh dp,tp,sp`` of ranks, each rank
  running its step on its shards; validated at 1e-4 of the peak against
  ``suite_reference``, a NumPy float32 golden of the logical pipeline.
* ``ICIBandwidth``: the interconnect micro-benchmark, a ring ppermute of
  ``--transferMiB`` MiB a rank plus an all-reduce over every rank. The
  ring is checked element for element, the reduction within
  max(1e-6, 16 sqrt(n) 2^-24).

Both run on one rank (a mesh of 1 x 1 x 1 needs no process group: its
collectives communicate nothing, and ICIBandwidth's ring is a device
copy of the chunk). A mesh of n > 1 ranks runs under
``parallel.launch.spmd`` (the CLI does that), every rank in lock step;
the host output of an iteration is read back whole on every rank
(``collectives.unshard``).

In place of the JAX package's ``metadata.ici_model`` (a model of the TPU
v5e interconnect, not ported), ``metadata.collectiveInventory`` lists
the collectives one step issued, as ``collectives.COLLECTIVES`` counted
them: kind, axis, axis size and bytes, no predicted times. It is empty
on one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import (
    ValidationData,
    compare_abs,
    compare_rel,
)
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    build_mesh,
    check_devices,
    parse_mesh,
)
from gpuaudiobench_tpu_torch.parallel.multichip import (
    OUT_DIMS,
    check_fp32_convolutions,
    make_suite_step,
    shard_args,
    suite_step_example_args,
)
from gpuaudiobench_tpu_torch.utils import device as dev


def suite_reference(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs,
                    n_stages: int):
    """Float32 NumPy reference for the logical multi-chip pipeline
    (parallel/multichip.py make_suite_step): gain -> biquad(stage 0) ->
    causal FIR -> + modal mix (track % 32) -> n_stages-deep cascade.
    The cascade depth equals the tp extent (one stage per rank)."""
    def biquad(sig, c):
        b0, b1, b2, a1, a2 = (np.float32(v) for v in c)
        z1 = np.zeros(sig.shape[0], np.float32)
        z2 = np.zeros(sig.shape[0], np.float32)
        out = np.empty_like(sig)
        for n in range(sig.shape[1]):
            w = sig[:, n] - a1 * z1 - a2 * z2
            out[:, n] = b0 * w + b1 * z1 + b2 * z2
            z2, z1 = z1, w
        return out

    t, s = x.shape
    y = biquad((np.float32(2.0) * x).astype(np.float32), stage_coeffs[0])
    conv = np.empty_like(y)
    for tr in range(t):
        conv[tr] = np.convolve(
            y[tr].astype(np.float64), ir.astype(np.float64)
        )[:s].astype(np.float32)

    re, im = s_re.astype(np.float32).copy(), s_im.astype(np.float32).copy()
    mix = np.empty((32, s), np.float32)
    for n in range(s):
        re, im = re * cos_w - im * sin_w, re * sin_w + im * cos_w
        mix[:, n] = (amp * re).reshape(-1, 32).sum(axis=0)

    mixed = conv + mix[np.arange(t) % 32, :]
    for k in range(n_stages):
        mixed = biquad(mixed, stage_coeffs[k])
    return mixed


class MultiChipSuiteBenchmark(Benchmark):
    name = "MultiChipSuite"
    tolerance = 1e-4  # relative to the golden's peak

    def setup(self) -> None:
        self.reject_data_parallel(
            "MultiChipSuite parallelism is set with --mesh dp,tp,sp, "
            "not --dataParallel")
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA
        shape = parse_mesh(self.cfg.mesh)
        self.mesh_shape = shape
        check_devices(shape, self.device)
        # Mode count kept modest by default: the suite step measures the
        # sharded pipeline + collectives, not peak modal throughput.
        modes = self.cfg.modal_num_modes or min(32 * self.track_count, 32768)
        tp = shape[1]
        if modes % (32 * tp) != 0:
            raise ValueError(
                f"MultiChipSuite needs --modalModes divisible by 32*tp "
                f"({32 * tp} for --mesh tp={tp}); got {modes}"
            )
        # The sp halo exchange ships the IR tail (L-1 samples) to the
        # right neighbor; the tail must fit inside one sample shard.
        ir_len = max(3, min(self.cfg.ir_length or 33,
                            self.buffer_size // shape[2]))
        self._ir_len = ir_len
        host = suite_step_example_args(
            shape, tracks=self.track_count, samples=self.buffer_size,
            modes=modes, ir_len=ir_len, seed=self.cfg.seed)
        self._shapes = [a.shape for a in host]
        # The sp halo ships L-1 samples; each sample shard must hold at
        # least that many or the VALID conv collapses to zero width.
        s_local = host[0].shape[1] // shape[2]
        if s_local < ir_len:
            raise ValueError(
                f"MultiChipSuite: per-shard sample count {s_local} "
                f"(bufferSize {self.buffer_size} over sp={shape[2]}) is "
                f"smaller than the FIR length {ir_len}; use a larger "
                "--bufferSize, smaller sp, or shorter --irLength"
            )
        if self.device.type == "cuda":
            check_fp32_convolutions(self.name)
        self.mesh = Mesh(shape, AXES)
        self._args = shard_args(host, self.mesh, self.device)
        self._step = make_suite_step(self.mesh)
        # A multi-rank chain is a loop: NCCL p2p inside a captured graph
        # is not tried here.
        self.stream_capturable = self.mesh.size == 1
        self.track_alloc("pipelineBuffers", sum(a.nbytes for a in host))

        # Golden: an independent NumPy implementation of the logical
        # pipeline (the cascade depth equals tp, one stage per rank).
        self.golden = None
        if self.cfg.verification != "none":
            self.golden = suite_reference(*host, n_stages=tp)
        self.host_output = None
        mark = len(col.COLLECTIVES)
        self.iterate()
        self._inventory = [dict(c) for c in col.COLLECTIVES[mark:]]

    def iterate(self) -> None:
        out = self._step(*self._args)
        self.host_output = dev.from_device(
            col.unshard(out, self.mesh, OUT_DIMS))

    def device_iterate(self) -> None:
        self._step(*self._args)

    def stream_body(self):
        # Stateless: every block runs the step on the same resident shards.
        def step(carry):
            return carry, probe(self._step(*carry))

        return step, self._args

    def validate(self) -> ValidationData:
        if self.golden is None:  # verification == "none" (no golden)
            return compare_rel(self.host_output, self.host_output,
                               self.tolerance, mode="none", label=self.name)
        floor = float(np.abs(self.golden).max())
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        # The mesh-trimmed shapes (suite_step_example_args may trim
        # tracks, samples and modes; metadata records them).
        t, s = self._shapes[0]
        modes = self._shapes[1][0]
        tp = self.mesh_shape[1]
        flops = (
            9 * t * s              # input biquad
            + 2 * t * s * self._ir_len  # FIR
            + 8 * modes * s        # modal bank
            + 9 * tp * t * s       # cascade (tp stages)
        )
        return {
            "flops": flops,
            "hbm_bytes": 2 * t * s * 4 + 6 * modes * 4,
            "unit": "vpu",
            "note": f"SPMD over mesh {self.mesh_shape}",
        }

    def metadata(self):
        return {
            "mesh": dict(zip(AXES, self.mesh_shape)),
            "modes": int(self._shapes[1][0]),
            "tracks": int(self._shapes[0][0]),
            "samples": int(self._shapes[0][1]),
            "collectiveInventory": self._inventory,
        }


class ICIBandwidthBenchmark(Benchmark):
    name = "ICIBandwidth"
    tolerance = 0.0  # exact

    def setup(self) -> None:
        self.reject_data_parallel(
            "ICIBandwidth spans all --mesh devices; --dataParallel "
            "does not apply")
        shape = parse_mesh(self.cfg.mesh)
        self.n_devices = int(np.prod(shape))
        self.mesh = build_mesh((self.n_devices,), ("ici",), self.device)
        self.chunk_elems = self.cfg.transfer_mib * 1024 * 1024 // 4
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        self.host_input = g.random(
            (self.n_devices, self.chunk_elems), dtype=np.float32
        )
        r = self.mesh.axis_index("ici")
        self._x = dev.to_device(self.host_input[r:r + 1], self.device)
        self.stream_capturable = self.mesh.size == 1
        self.track_alloc("chunks", self.host_input.nbytes * 2)
        self.host_output = None
        self.host_total = None
        mark = len(col.COLLECTIVES)
        self.iterate()
        self._inventory = [dict(c) for c in col.COLLECTIVES[mark:]]

    def _step(self, x: torch.Tensor):
        # Ring shift: every rank ships its chunk to the right neighbour
        # (on one rank, a device copy of it), then an all-reduce of the
        # per-rank sums.
        n = self.n_devices
        shifted = (col.ppermute(x, self.mesh, "ici", col.ring(n)) if n > 1
                   else x.clone())
        total = col.psum(torch.sum(x, dim=1, keepdim=True), self.mesh, "ici")
        return shifted, total

    def iterate(self) -> None:
        shifted, total = self._step(self._x)
        self.host_output = dev.from_device(
            col.unshard(shifted, self.mesh, ("ici", None)))
        self.host_total = dev.from_device(
            col.unshard(total, self.mesh, ("ici", None)))

    def device_iterate(self) -> None:
        self._step(self._x)

    def stream_body(self):
        def step(x):
            shifted, total = self._step(x)
            return x, probe(shifted) + probe(total)

        return step, self._x

    def validate(self) -> ValidationData:
        golden = np.roll(self.host_input, 1, axis=0)  # ring shift
        v = compare_abs(
            self.host_output, golden, 1e-6,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} ppermute",
        )
        expect_total = np.full(
            (self.n_devices, 1),
            self.host_input.astype(np.float64).sum(),
            np.float32,
        )
        # f32 summation error is reduction-order dependent and grows
        # ~sqrt(n); a fixed 1e-6 already had only ~3x margin at the
        # default 10 MiB chunk and would flake at --transferMiB 1024.
        n_sum = self.n_devices * self.chunk_elems
        sum_tol = max(1e-6, 16.0 * float(np.sqrt(n_sum)) * 2.0 ** -24)
        v.merge_failure(
            compare_rel(
                self.host_total, expect_total, sum_tol,
                mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
                label=f"{self.name} psum",
            )
        )
        return v

    def total_elements(self) -> int:
        return self.n_devices * self.chunk_elems

    def bytes_processed(self) -> int:
        # bytes crossing the interconnect: one chunk per rank per direction
        return 2 * self.n_devices * self.chunk_elems * 4

    def cost_model(self):
        return {
            "flops": self.total_elements(),  # the reduce
            "hbm_bytes": 2 * self.total_elements() * 4,
            "unit": "vpu",
            "note": "ICI ring hop + all-reduce; GB/s = bytes/device_ms",
        }

    def metadata(self):
        return {
            "devices": self.n_devices,
            "chunkMiB": self.cfg.transfer_mib,
            "collectives": ["ppermute(ring)", "psum"],
            "collectiveInventory": self._inventory,
        }
