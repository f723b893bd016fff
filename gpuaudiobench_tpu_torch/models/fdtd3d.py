"""FDTD3D: 3-D room acoustics on a pressure-velocity staggered grid
(cuda/bench_fdtd3d.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/fdtd3d.py``. A room of
``--fdtdRoom`` cells per axis (50 by default: a 52^3 grid with its
boundary), c = 343, dx = 0.01, rho = 1.225, absorption 0.2,
dt = 0.5*dx/(c*sqrt(3)), 3 steps per audio sample
(bench_fdtd3d.cuh:145-174). The source is the sum of all tracks; one
receiver cell is broadcast to every track, or with
``--fdtdPerTrackReceivers`` each track reads its own cell on a line
across the room. Each iteration runs the whole bufferSize x 3 step block
in one launch of a hand-written CUDA kernel: the divergence form
(``ops.fdtd3d.fdtd3d_block_div``) by default, the field form
(``fdtd3d_block_field``) with per-track receivers (where the JAX package
runs XLA).

Golden: the full float32 NumPy FDTD simulation ``fdtd3d_reference``,
computed at setup, at 5e-3 absolute (Metal's full-simulation tolerance).
The fields are re-zeroed on each ``iterate()``, so every iteration equals
the golden pass; the stream carries them from block to block.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_abs
from gpuaudiobench_tpu_torch.ops import fdtd3d as op
from gpuaudiobench_tpu_torch.utils import device as dev
from gpuaudiobench_tpu_torch.utils.data import generate_random_audio


def fdtd3d_reference(x: np.ndarray, steps_per_sample: int = op.STEPS_PER_SAMPLE,
                     receivers=None, n: int = op.GRID_N,
                     source: tuple = op.SOURCE,
                     receiver: tuple = op.RECEIVER):
    """Full float32 NumPy FDTD simulation from rest, (tracks, S).
    receivers: optional (xs, ys, zs) per-track arrays; None = the single
    broadcast receiver."""
    k1 = np.float32(op.DT_OVER_RHO_DX)
    k2 = np.float32(op.RHO_C2_DT_OVER_DX)
    absorb = np.float32(1.0 - op.ABSORPTION)
    p = np.zeros((n, n, n), np.float32)
    vx = np.zeros((n + 1, n, n), np.float32)
    vy = np.zeros((n, n + 1, n), np.float32)
    vz = np.zeros((n, n, n + 1), np.float32)

    idx = np.arange(n)
    edge = (idx == 0) | (idx == n - 1)
    boundary = edge[:, None, None] | edge[None, :, None] | edge[None, None, :]
    sx, sy, sz = source
    rx, ry, rz = receiver

    tracks, s = x.shape
    src = x.sum(axis=0, dtype=np.float32) * np.float32(op.SOURCE_SCALE)
    if receivers is None:
        rcv = np.zeros((1, s), np.float32)
    else:
        rcv = np.zeros((tracks, s), np.float32)
    for smp in range(s):
        p[sx, sy, sz] += src[smp]
        for _ in range(steps_per_sample):
            vx[1:n, :, :] -= k1 * (p[1:, :, :] - p[:-1, :, :])
            vy[:, 1:n, :] -= k1 * (p[:, 1:, :] - p[:, :-1, :])
            vz[:, :, 1:n] -= k1 * (p[:, :, 1:] - p[:, :, :-1])
            div = (
                (vx[1:, :, :] - vx[:-1, :, :])
                + (vy[:, 1:, :] - vy[:, :-1, :])
                + (vz[:, :, 1:] - vz[:, :, :-1])
            )
            p = np.where(boundary, p * absorb, p - k2 * div)
        if receivers is None:
            rcv[0, smp] = p[rx, ry, rz] * np.float32(op.OUTPUT_SCALE)
        else:
            xs, ys, zs = receivers
            rcv[:, smp] = p[xs, ys, zs] * np.float32(op.OUTPUT_SCALE)
    if receivers is None:
        return np.broadcast_to(rcv, (tracks, s)).copy()
    return rcv


def fdtd3d_cost(room: int, samples: int, tracks: int,
                per_track_receivers: bool) -> dict:
    """A block's cost in the form that runs: the divergence form (the
    broadcast receiver) or the field form (per-track receivers).

    Operations per substep: a boundary cell 1 (p * (1 - absorption)); an
    interior cell of the div form 11 (5 adds for the neighbours' sum, 4
    for div', 2 for p'); the field form 3 for each of the 3 (n-1) n^2
    updated faces, then 7 for an interior cell (5 for the divergence, 2
    for p'). Per sample and track the source sum and the receiver's
    scale, and per sample the injection. Bytes: the input block read, the
    output written, the carried fields read and written once (p and div,
    or p, vx, vy, vz), and the receiver cells read for the field form.
    ``vmem_bytes`` is the on-chip traffic floor: the carried fields loaded
    and stored once a substep. The reference
    (``gpuaudiobench_tpu/models/fdtd3d.py:195``) counts 20 FLOP a cell
    for both forms, the field form's bytes for both, and its floor on the
    TPU's padded (n+1)^3 layout. ``chip_smoke.py``'s bounds read this
    count too."""
    n = op.grid_n(room)
    cells, faces = n ** 3, (n + 1) * n * n
    interior = (n - 2) ** 3
    edge = cells - interior
    substeps = samples * op.STEPS_PER_SAMPLE
    per_block = 2 * tracks * samples + 2 * samples
    io = 2 * tracks * samples * 4
    if per_track_receivers:
        flops = substeps * (9 * (n - 1) * n * n + 7 * interior + edge)
        state = cells + 3 * faces
        hbm = io + 2 * state * 4 + 4 * tracks
        form = "field"
    else:
        flops = substeps * (11 * interior + edge)
        state = 2 * cells
        hbm = io + 2 * state * 4
        form = "divergence"
    return {
        "flops": flops + per_block,
        "hbm_bytes": hbm,
        "vmem_bytes": substeps * state * 2 * 4,
        "unit": "vpu",
        "note": f"{form} form; vmem_bytes is the carried fields' load and "
                "store a substep",
    }


class FDTD3DBenchmark(Benchmark):
    name = "FDTD3D"
    tolerance = 5e-3  # Metal full-sim tolerance (FDTD3DBenchmark.swift)

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self._impl = self.resolve_impl()  # raises for impl xla on CUDA
        self._room = cfg.fdtd_room
        self._n = op.grid_n(self._room)
        self._source = op.source_pos(self._room)
        self._receiver = op.receiver_pos(self._room)

    def setup(self) -> None:
        self.reject_data_parallel(
            "FDTD3D has no data-parallel axis (one shared acoustic "
            "field); multi-chip FDTD uses domain decomposition -- see "
            "parallel/fdtd_sharded.py (tests/test_multichip.py)"
        )
        t, s = self.track_count, self.buffer_size
        self.load_data(generate_random_audio(t * s, self.cfg.seed).reshape(t, s))

    def load_data(self, host_input: np.ndarray,
                  stream_fields: Optional[Sequence[np.ndarray]] = None) -> None:
        """Take the (tracks, S) input block (e.g. a JAX benchmark's
        ``host_input``) and, optionally, the fields the stream starts
        from, (p, div) or with per-track receivers (p, vx, vy, vz); compute
        the golden (none under verification "none") and run one
        iteration. ``setup`` calls it with the seeded input; the stream
        then starts at rest."""
        t, s, n = self.track_count, self.buffer_size, self._n
        if host_input.shape != (t, s) or host_input.dtype != np.float32:
            raise ValueError(f"{self.name}: input must be float32 ({t}, {s}), "
                             f"got {host_input.dtype} {host_input.shape}")
        self.host_input = host_input
        self._resident_input = dev.to_device(host_input, self.device)
        self.track_alloc("pressureField", n * n * n * 4)
        self.track_alloc("velocityFields", 3 * (n + 1) * n * n * 4)
        self.track_alloc("ioBuffers", t * s * 4 * 4)
        self._receivers = None
        if self.cfg.fdtd_per_track_receivers:
            self._receivers = op.receiver_line(t, n)
            xs, ys, zs = self._receivers
            rcv_flat = dev.to_device(
                ((xs.astype(np.int64) * n + ys) * n + zs).astype(np.int32),
                self.device)
            self._block = functools.partial(
                op.fdtd3d_block_field, source=self._source,
                receiver=self._receiver, receivers=rcv_flat)
            zero = op.zero_fields
        else:
            self._block = functools.partial(
                op.fdtd3d_block_div, source=self._source,
                receiver=self._receiver)
            zero = op.zero_fields_div
        self._zero_fields = zero(n, self.device)
        if stream_fields is None:
            self._stream_fields = self._zero_fields
        else:
            want = [tuple(f.shape) for f in self._zero_fields]
            got = [np.shape(f) for f in stream_fields]
            if got != want:
                raise ValueError(f"{self.name}: stream fields must be {want}, "
                                 f"got {got}")
            self._stream_fields = tuple(
                dev.to_device(np.array(f, np.float32), self.device)
                for f in stream_fields)
        # Verification "none" computes no golden: the NumPy simulation
        # takes most of a minute at room 82 x 512 samples.
        self.golden = None if self.cfg.verification == "none" else (
            fdtd3d_reference(host_input, receivers=self._receivers, n=n,
                             source=self._source, receiver=self._receiver))
        self.host_output = None
        self.iterate()

    def iterate(self) -> None:
        x = dev.to_device(self.host_input, self.device)
        out, *_ = self._block(x, *self._zero_fields)
        self.host_output = dev.from_device(out)

    def device_iterate(self) -> None:
        self._block(self._resident_input, *self._zero_fields)

    def stream_body(self):
        block = self._block

        def step(carry):
            x, fields = carry
            out, *new_fields = block(x, *fields)
            return (x, tuple(new_fields)), probe(out)

        return step, (self._resident_input, self._stream_fields)

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        return fdtd3d_cost(self._room, self.buffer_size, self.track_count,
                           self.cfg.fdtd_per_track_receivers)

    def metadata(self):
        return {
            "impl": self._impl,
            "room": self._room,
            "grid": [self._n] * 3,
            "stepsPerSample": op.STEPS_PER_SAMPLE,
            "soundSpeed": op.SOUND_SPEED,
            "spatialStep": op.SPATIAL_STEP,
            "timeStep": op.TIME_STEP,
            "absorption": op.ABSORPTION,
            "source": list(self._source),
            "receiver": "per-track line" if self._receivers is not None
                        else list(self._receiver),
        }
