"""3-D FDTD room acoustics on a staggered (Yee) pressure-velocity grid.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/fdtd3d.py`` and
``ops/fdtd3d_pallas.py``: the constants, the room geometry and two block
functions with the contracts of the JAX package's, each a wrapper of a
hand-written CUDA kernel (``csrc/fdtd3d.cu``) beside its plain twin. A
block is S samples x 3 substeps of (float32, absorbing boundaries)

  vx[x,y,z] += -k1 * (p[x,y,z] - p[x-1,y,z])   x in [1, n-1]  (vy, vz alike)
  p[interior] -= k2 * div(v) ; p[boundary] *= (1 - absorption)

with the source p[src] += sum_tracks(x[:, n]) * 0.1 at the start of
sample n, and out[t, n] = p[rcv(t)] * 0.1 after its last substep.

* ``fdtd3d_block_div(x, p, div)`` -> (out (T, S), p', div'): the
  divergence form, which carries (p, div v) and replaces the Pallas
  ``_fdtd_kernel_div`` (``fdtd3d_block_pallas_div``); div' is zero off
  the interior, as that wrapper returns it.
* ``fdtd3d_block_field(x, p, vx, vy, vz, receivers=None)`` -> (out, p',
  vx', vy', vz'): the field form, which replaces the Pallas
  ``_fdtd_kernel`` (``fdtd3d_block_pallas``). With ``receivers``, an
  int32 (T,) tensor of flat cells, track t reads its own cell, as the JAX
  ``fdtd3d_block_multircv`` (XLA only there) does; without, every track
  reads the one ``receiver`` cell.
* ``fdtd3d_block_div_plain`` and ``fdtd3d_block_field_plain`` are their
  twins: the sample loop of the JAX functions, whole-grid tensor ops per
  substep in the order of their expressions.

A wrapper runs the twin only because its tensors lie on the CPU. On a
CUDA tensor it launches the kernel or raises; it never falls back. The
input fields are never written.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Physics constants (bench_fdtd3d.cuh:145-174).
ROOM = 50  # reference default; --fdtdRoom makes it configurable
GRID_N = ROOM + 2  # +2 ghost/boundary cells
SOUND_SPEED = 343.0
SPATIAL_STEP = 0.01
AIR_DENSITY = 1.225
ABSORPTION = 0.2
CFL = 0.5
STEPS_PER_SAMPLE = 3  # kFDTD3D_StepsPerSample
TIME_STEP = CFL * SPATIAL_STEP / (SOUND_SPEED * 1.7320508)
# The reference's room-50 cells, with the one-cell ghost offset.
SOURCE = (26, 26, 6)
RECEIVER = (41, 16, 26)
SOURCE_SCALE = 0.1  # benchmark_constants.cuh FDTD3D_SOURCE_SCALE
OUTPUT_SCALE = 0.1

DT_OVER_RHO_DX = TIME_STEP / (AIR_DENSITY * SPATIAL_STEP)
RHO_C2_DT_OVER_DX = AIR_DENSITY * SOUND_SPEED**2 * TIME_STEP / SPATIAL_STEP

# The float32 values the updates use (as jnp.float32 rounds them).
K1 = float(np.float32(DT_OVER_RHO_DX))
K2 = float(np.float32(RHO_C2_DT_OVER_DX))
C6 = float(np.float32(6.0) * np.float32(DT_OVER_RHO_DX))
ABSORB = float(np.float32(1.0 - ABSORPTION))
F_SOURCE_SCALE = float(np.float32(SOURCE_SCALE))
F_OUTPUT_SCALE = float(np.float32(OUTPUT_SCALE))

# Launches of each CUDA kernel, counted by its wrapper where it launches
# it (chip_smoke.py reads them to prove the main path used the kernels).
KERNEL_LAUNCHES: Dict[str, int] = {"fdtd3d_div": 0, "fdtd3d_field": 0}

Cell = Tuple[int, int, int]


def grid_n(room: int) -> int:
    return room + 2


def source_pos(room: int) -> Cell:
    """Source cell: the reference's room fractions (0.5, 0.5, 0.1) plus
    the ghost offset; (26, 26, 6) at room 50."""
    return (room // 2 + 1, room // 2 + 1, room // 10 + 1)


def receiver_pos(room: int) -> Cell:
    """Receiver cell: room fractions (0.8, 0.3, 0.5) plus the ghost
    offset; (41, 16, 26) at room 50."""
    return (room * 8 // 10 + 1, room * 3 // 10 + 1, room // 2 + 1)


def receiver_line(tracks: int, n: int = GRID_N):
    """Per-track receiver cells (xs, ys, zs): a line across x at mid y/z
    (the WebGPU convention), x in [1, n-2] so edge tracks read interior
    cells."""
    i = np.arange(tracks)
    ratio = i / (tracks - 1) if tracks > 1 else np.full(tracks, 0.5)
    xs = (1 + np.floor(ratio * (n - 3))).astype(np.int32)
    ys = np.full(tracks, n // 2, np.int32)
    zs = np.full(tracks, n // 2, np.int32)
    return xs, ys, zs


def flat_cell(cell: Cell, n: int) -> int:
    x, y, z = cell
    return (x * n + y) * n + z


def zero_fields(n: int = GRID_N, device="cpu"):
    """(p, vx, vy, vz) at rest, for the field form."""
    return (
        torch.zeros((n, n, n), dtype=torch.float32, device=device),
        torch.zeros((n + 1, n, n), dtype=torch.float32, device=device),
        torch.zeros((n, n + 1, n), dtype=torch.float32, device=device),
        torch.zeros((n, n, n + 1), dtype=torch.float32, device=device),
    )


def zero_fields_div(n: int = GRID_N, device="cpu"):
    """(p, div) at rest, for the divergence form (v = 0, so div v = 0)."""
    return (torch.zeros((n, n, n), dtype=torch.float32, device=device),
            torch.zeros((n, n, n), dtype=torch.float32, device=device))


def source_row(x: torch.Tensor) -> torch.Tensor:
    """The soft source per sample: the sum over tracks x 0.1, (S,)."""
    return x.sum(dim=0) * F_SOURCE_SCALE


def boundary_mask(n: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    edge = (idx == 0) | (idx == n - 1)
    return edge[:, None, None] | edge[None, :, None] | edge[None, None, :]


def _taps_to_out(taps: torch.Tensor, tracks: int) -> torch.Tensor:
    """(S, R) receiver taps -> (T, S): R == T, or one row broadcast."""
    out = taps.t()
    return out.expand(tracks, -1).contiguous()


def fdtd3d_block_field_plain(x, p, vx, vy, vz, source: Cell = SOURCE,
                             receiver: Cell = RECEIVER,
                             receivers: Optional[torch.Tensor] = None):
    """The JAX ``fdtd3d_block`` (or, with ``receivers``,
    ``fdtd3d_block_multircv``): (out (T, S), p', vx', vy', vz')."""
    n = p.shape[0]
    tracks, s = x.shape
    src = source_row(x)
    p, vx, vy, vz = p.clone(), vx.clone(), vy.clone(), vz.clone()
    boundary = boundary_mask(n, p.device)
    cells = (receivers.to(torch.int64) if receivers is not None else
             torch.tensor([flat_cell(receiver, n)], device=p.device))
    taps = torch.empty((s, cells.shape[0]), dtype=torch.float32,
                       device=p.device)
    for smp in range(s):
        p[source] = p[source] + src[smp]
        for _ in range(STEPS_PER_SAMPLE):
            vx[1:n] += -K1 * (p[1:] - p[:-1])
            vy[:, 1:n] += -K1 * (p[:, 1:] - p[:, :-1])
            vz[:, :, 1:n] += -K1 * (p[:, :, 1:] - p[:, :, :-1])
            div = ((vx[1:] - vx[:-1]) + (vy[:, 1:] - vy[:, :-1])
                   + (vz[:, :, 1:] - vz[:, :, :-1]))
            p = torch.where(boundary, p * ABSORB, p - K2 * div)
        taps[smp] = p.reshape(-1)[cells] * F_OUTPUT_SCALE
    return _taps_to_out(taps, tracks), p, vx, vy, vz


def fdtd3d_block_div_plain(x, p, div, source: Cell = SOURCE,
                           receiver: Cell = RECEIVER):
    """The divergence form of ``fdtd3d_block_pallas_div``:
    (out (T, S), p', div'), div' zero off the interior."""
    tracks, s = x.shape
    src = source_row(x)
    inner = (slice(1, -1),) * 3
    p = p.clone()
    d = torch.zeros_like(div)
    d[inner] = div[inner]
    taps = torch.empty((s, 1), dtype=torch.float32, device=p.device)
    for smp in range(s):
        p[source] = p[source] + src[smp]
        for _ in range(STEPS_PER_SAMPLE):
            pc = p[inner]
            nb = p[2:, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1]
            nb = nb + (p[1:-1, 2:, 1:-1] + p[1:-1, :-2, 1:-1])
            nb = nb + (p[1:-1, 1:-1, 2:] + p[1:-1, 1:-1, :-2])
            di = (d[inner] + C6 * pc) - K1 * nb
            d[inner] = di
            p2 = p * ABSORB
            p2[inner] = pc - K2 * di
            p = p2
        taps[smp] = p[receiver] * F_OUTPUT_SCALE
    return _taps_to_out(taps, tracks), p, d


def _check(x, fields, source: Cell, receiver: Cell,
           receivers: Optional[torch.Tensor], fn: str) -> int:
    """Validates the inputs; returns the grid size n."""
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{fn}: x must be (tracks, samples), got "
                         f"{tuple(x.shape)}")
    n = fields[0][1].shape[0]
    for label, t, want in [("x", x, tuple(x.shape))] + [
            (lbl, t, tuple(n + d for d in off)) for lbl, t, off in fields]:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {label} must be float32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{fn}: {label} must be {want}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {label} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{fn}: {label} on {t.device}, x on {x.device}")
    if n < 3:
        raise ValueError(f"{fn}: a grid of {n} cells per axis has no interior")
    for label, cell in (("source", source), ("receiver", receiver)):
        if len(cell) != 3 or not all(0 <= c < n for c in cell):
            raise ValueError(f"{fn}: {label} {cell} outside the {n}^3 grid")
    if receivers is not None:
        if receivers.dtype != torch.int32 or tuple(receivers.shape) != (x.shape[0],):
            raise ValueError(f"{fn}: receivers must be int32 ({x.shape[0]},), "
                             f"got {receivers.dtype} {tuple(receivers.shape)}")
        if not receivers.is_contiguous() or receivers.device != x.device:
            raise ValueError(f"{fn}: receivers must be contiguous, on "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for {x.device}")
    return n


def _lib() -> ctypes.CDLL:
    from gpuaudiobench_tpu_torch.utils.build import load

    lib = load("fdtd3d")
    if lib.fdtd_div_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fdtd_div_launch.argtypes = [p] * 8 + [i] * 5 + [f] * 5 + [p]
        lib.fdtd_div_launch.restype = i
        lib.fdtd_field_launch.argtypes = [p] * 16 + [i] * 5 + [f] * 4 + [p]
        lib.fdtd_field_launch.restype = i
        lib.fdtd_div_blocks.argtypes = [i]
        lib.fdtd_div_blocks.restype = i
        lib.fdtd_sync_probe_launch.argtypes = [i, i, p]
        lib.fdtd_sync_probe_launch.restype = i
    return lib


def _empty(n_shape, like):
    return torch.empty(n_shape, dtype=torch.float32, device=like.device)


def fdtd3d_block_div(x, p, div, source: Cell = SOURCE,
                     receiver: Cell = RECEIVER):
    """Divergence-form block: (out (T, S), p', div'); the grid size rides
    p.shape (room + 2 ghost cells)."""
    n = _check(x, [("p", p, (0, 0, 0)), ("div", div, (0, 0, 0))], source,
               receiver, None, "fdtd3d_block_div")
    if x.device.type == "cpu":
        return fdtd3d_block_div_plain(x, p, div, source, receiver)
    lib = _lib()
    tracks, s = x.shape
    src = source_row(x)
    pa, pb, div_out = (_empty((n, n, n), x) for _ in range(3))
    out = _empty((tracks, s), x)
    src_pre = _empty((1,), x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fdtd_div_launch(
            src.data_ptr(), p.data_ptr(), div.data_ptr(), pa.data_ptr(),
            pb.data_ptr(), div_out.data_ptr(), out.data_ptr(),
            src_pre.data_ptr(), n, s, flat_cell(source, n), tracks,
            flat_cell(receiver, n), K1, K2, C6, ABSORB, F_OUTPUT_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"fdtd_div_launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["fdtd3d_div"] += 1
    return out, (pa if s % 2 == 0 else pb), div_out


def fdtd3d_block_field(x, p, vx, vy, vz, source: Cell = SOURCE,
                       receiver: Cell = RECEIVER,
                       receivers: Optional[torch.Tensor] = None):
    """Field-form block: (out (T, S), p', vx', vy', vz'); ``receivers``
    (int32 (T,) flat cells) gives each track its own receiver."""
    n = _check(x, [("p", p, (0, 0, 0)), ("vx", vx, (1, 0, 0)),
                   ("vy", vy, (0, 1, 0)), ("vz", vz, (0, 0, 1))],
               source, receiver, receivers, "fdtd3d_block_field")
    if x.device.type == "cpu":
        return fdtd3d_block_field_plain(x, p, vx, vy, vz, source, receiver,
                                        receivers)
    lib = _lib()
    tracks, s = x.shape
    src = source_row(x)
    pa, pb = _empty((n, n, n), x), _empty((n, n, n), x)
    vs = [(_empty(t.shape, x), _empty(t.shape, x)) for t in (vx, vy, vz)]
    out = _empty((tracks, s), x)
    src_pre = _empty((1,), x)
    rows = None if receivers is None else receivers.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fdtd_field_launch(
            src.data_ptr(), p.data_ptr(), vx.data_ptr(), vy.data_ptr(),
            vz.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            *(b.data_ptr() for pair in vs for b in pair), out.data_ptr(),
            src_pre.data_ptr(), rows, n, s, flat_cell(source, n), tracks,
            flat_cell(receiver, n), K1, K2, ABSORB, F_OUTPUT_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"fdtd_field_launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["fdtd3d_field"] += 1
    last = 0 if s % 2 == 0 else 1
    return (out, (pa, pb)[last], vs[0][last], vs[1][last], vs[2][last])


def sync_probe(n: int, syncs: int, device) -> None:
    """Launch ``syncs`` grid-wide barriers alone, on as many blocks as the
    divergence kernel takes for an n^3 grid: a measurement of the barrier
    (not a kernel of any benchmark; not counted in KERNEL_LAUNCHES)."""
    lib = _lib()
    device = torch.device(device)
    with torch.cuda.device(device):
        blocks = lib.fdtd_div_blocks(n)
        if blocks <= 0:
            raise RuntimeError("fdtd_div_blocks: no cooperative launch on "
                               f"{device}")
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fdtd_sync_probe_launch(syncs, blocks, stream)
    if err != 0:
        raise RuntimeError(f"fdtd_sync_probe_launch failed: CUDA error {err}")
