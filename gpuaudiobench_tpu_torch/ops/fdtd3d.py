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
  ``fdtd3d_block_multircv`` (XLA only there) does, a cell outside the
  grid read as its gather reads it (``normalize_receivers``); without,
  every track reads the one ``receiver`` cell.
* ``fdtd3d_block_div_plain`` and ``fdtd3d_block_field_plain`` are their
  twins: the sample loop of the JAX functions, whole-grid tensor ops per
  substep in the order of their expressions.
* ``receiver_buckets(receivers, n)`` -> (cells, order, starts): the
  per-track receivers normalized and bucketed by x-plane for the field
  kernel, by a kernel of their own on the device (``receiver_buckets_plain``
  its twin, ``receiver_csr`` the NumPy reference of the buckets).

A wrapper runs the twin only because its tensors lie on the CPU (and
calls the operator, whose CPU implementation is the twin, while a CPU
program is traced). On a CUDA tensor it launches a kernel or raises; it
never falls back. The kernels are reached through the
``torch.ops.gpuab.fdtd_div_{cluster,planes}_launch`` and
``fdtd_field_planes_launch`` operators (``ops/gpuab.py``), and the
per-track receivers' buckets through ``fdtd_receiver_buckets``; an
exported program calls them too. The library's ctypes
handle (``_lib``, ``bind``) serves the capacity and shared-memory queries
(``fdtd_*_capacity``, ``fdtd_*_smem``, ``fdtd_cluster_occupancy``) and
the cluster-barrier probe (``cluster_probe``, a measurement, not a kernel
of any benchmark); ``bind`` also declares the launch entries for the
builds of ``tools/fdtd_stages``. The input fields are never written.
Which kernel runs is decided before the
launch by ``fdtd_schedule(n, form)``, pure host code, as a route,
"cluster" or "planes". In the divergence form a room whose (p,
div) fits in one thread-block cluster's shared memory (rooms up to 65;
room 50 on 16 blocks) takes the cluster kernel (``fdtd3d_div`` in
``KERNEL_LAUNCHES``), a larger one (rooms 66-128) the plane kernel, one
cooperative launch of a block a plane that hands the planes on through
L2 (``plane_schedule``; ``fdtd3d_div_coop``). The field form takes its
plane kernel at every room (``plane_schedule(n, "field")``;
``fdtd3d_field``), with the per-track receivers bucketed by plane on the
device just before it (``fdtd3d_receiver_buckets``). The route-specific
launchers
``fdtd3d_block_div_{cluster,coop}`` take CUDA tensors only; they let the
tests and ``chip_smoke.py`` hold one route against the other at a room
both can serve (the plane kernels serve every room from n = 3).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gpuaudiobench_tpu_torch.ops import gpuab

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
# it (chip_smoke.py reads them to prove the main path used the kernels):
# the divergence form's cluster kernel under the form's name, its plane
# kernel with "_coop"; the field form's one kernel, and the kernel that
# buckets its per-track receivers.
KERNEL_LAUNCHES: Dict[str, int] = {"fdtd3d_div": 0, "fdtd3d_div_coop": 0,
                                   "fdtd3d_field": 0,
                                   "fdtd3d_receiver_buckets": 0}

# The cluster route (csrc/fdtd3d.cu): blocks of 1,024 threads, at most
# 16 in a cluster (a non-portable size on sm_90), each with at most the
# 232,448 bytes of shared memory a block can opt into on sm_90, each
# thread at most 19 cells (the largest build).
CLUSTER_THREADS = 1024
MAX_CLUSTER_BLOCKS = 16
SMEM_PER_BLOCK = 232_448
MAX_CELLS_PER_THREAD = 19
# The plane route: one block of 1,024 threads a plane, each block's flag
# 32 ints (a 128-byte line) from the next. The field form's plane kernel
# keeps the upper faces' replicas in registers up to this many cells a
# thread, vy and vz in shared memory above (csrc/fdtd3d.cu:
# kRegFacesMaxCpt); its builds go up to 17 cells a thread.
PLANE_FLAG_STRIDE = 32
FIELD_REG_FACES_MAX_CPT = 7
FIELD_MAX_CELLS_PER_THREAD = 17
# The largest grid whose planes the field kernel's launcher and the
# bucketing kernel take (csrc/fdtd3d.cu:kMaxPlanes).
FIELD_MAX_PLANES = 139
FORMS = ("div", "field")


@dataclass(frozen=True)
class FdtdPlan:
    """How one block of an n^3 grid runs: ``route`` "cluster" (one
    cluster of ``blocks`` blocks) or "planes" (one cooperative launch of a
    block a plane). Block b owns the flat cells ``ranges[b]``, which the
    kernel is given, and takes ``smem_bytes`` of dynamic shared memory."""

    route: str
    blocks: int
    ranges: Tuple[Tuple[int, int], ...]
    smem_bytes: int


def cluster_smem_bytes(n: int, cap: int) -> int:
    """Dynamic shared memory a block of the cluster kernel takes for ranges
    of at most ``cap`` cells (csrc/fdtd3d.cu:div_cluster_smem): 8 floats
    of mbarriers and the source cell's pre-injection value, then two p
    buffers of [n^2 | range | n^2], each padded by 1,036 floats (the last
    partial iteration of 1,024 threads loads in bounds) and rounded up to
    4."""
    return 4 * (8 + 2 * ((cap + 2 * n * n + 12 + CLUSTER_THREADS + 3)
                         // 4 * 4))


def plane_stride(n: int) -> int:
    """Floats of one plane's slot in the plane kernel's exchange buffer
    (csrc/fdtd3d.cu:plane_stride): n^2 cells and 1,036 floats of padding
    (the last partial iteration of 1,024 threads loads in bounds), rounded
    up to 4."""
    return (n * n + 12 + CLUSTER_THREADS + 3) // 4 * 4


def cells_per_thread(cells: int) -> int:
    """The build a block of ``cells`` cells takes: its iterations of
    1,024 cells, rounded up to odd (csrc/fdtd3d.cu:cells_per_thread)."""
    return -(-cells // CLUSTER_THREADS) | 1


def planes_smem_bytes(n: int, form: str = "div") -> int:
    """Dynamic shared memory a block of a plane kernel takes
    (csrc/fdtd3d.cu:div_planes_smem, field_planes_smem): 8 floats, then
    buffers of the block's plane, each with a lead of (n + 4) rounded down
    to 4 floats ahead and behind (the rows above and below load in bounds)
    and one iteration of 1,024 cells, rounded up to 4: two (p) in the
    divergence form and in the field form's builds that keep the faces in
    registers, three (one of p, vy, vz) in its others."""
    lead = (n + 4) // 4 * 4
    bufs = 2
    if form == "field" and cells_per_thread(n * n) > FIELD_REG_FACES_MAX_CPT:
        bufs = 3
    return 4 * (8 + bufs * ((2 * lead + n * n + CLUSTER_THREADS + 3)
                            // 4 * 4))


def plane_schedule(n: int, form: str = "div") -> FdtdPlan:
    """The plane route of an n^3 grid in ``form``: n blocks of 1,024
    threads, block b owning x-plane b, so an interior cell's +-1 and +-n
    neighbours lie in its own plane and its +-n^2 ones in the adjacent
    ranges. Raises when no build of the form's kernel takes n^2 cells a
    block, or its layout does not fit a block's shared memory; whether
    the card holds n blocks at once is the launch's check."""
    nn = n * n
    cap = (FIELD_MAX_CELLS_PER_THREAD if form == "field"
           else MAX_CELLS_PER_THREAD)
    smem = planes_smem_bytes(n, form)
    if n < 3 or nn > cap * CLUSTER_THREADS or smem > SMEM_PER_BLOCK:
        raise ValueError(f"plane_schedule: no plane kernel for an {n}^3 "
                         f"grid in the {form} form")
    return FdtdPlan("planes", n,
                    tuple((b * nn, (b + 1) * nn) for b in range(n)), smem)


def fdtd_schedule(n: int, form: str) -> FdtdPlan:
    """The route of an n^3 grid in ``form`` ("div" or "field"). In the
    divergence form a cluster of the largest power of two of blocks up to
    16 and n (so each range holds at least n^2 cells and a +-1, +-n or
    +-n^2 neighbour lies in the block's own range or an adjacent one), on
    balanced ranges, takes the grid when every block's layout fits its
    shared memory and the largest build's cells a thread; otherwise the
    plane route (``plane_schedule``) does. The field form takes its plane
    route at every room (rooms up to 129 have a build)."""
    if form not in FORMS:
        raise ValueError(f"fdtd_schedule: form must be one of {FORMS}, "
                         f"got {form!r}")
    if form == "field":
        return plane_schedule(n, "field")
    blocks = MAX_CLUSTER_BLOCKS
    while blocks > n:
        blocks //= 2
    cells = n ** 3
    cap = -(-cells // blocks)
    smem = cluster_smem_bytes(n, cap)
    if (cells // blocks < n * n or smem > SMEM_PER_BLOCK
            or cap > MAX_CELLS_PER_THREAD * CLUSTER_THREADS):
        return plane_schedule(n)
    ranges = tuple((b * cells // blocks, (b + 1) * cells // blocks)
                   for b in range(blocks))
    return FdtdPlan("cluster", blocks, ranges, smem)


def range_starts(plan: FdtdPlan):
    """The plan's ranges as csrc/fdtd3d.cu takes them: blocks + 1 ints,
    block b owning [starts[b], starts[b + 1])."""
    return [lo for lo, _ in plan.ranges] + [plan.ranges[-1][1]]


def normalize_receivers(receivers: torch.Tensor, n: int) -> torch.Tensor:
    """The flat cells (int64) that per-track receivers read in an n^3
    grid, as the JAX package's ``p.ravel()[rcv]`` reads them: a negative
    cell wrapped once by n^3, then every cell clamped to [0, n^3 - 1]."""
    cells = n ** 3
    r = receivers.to(torch.int64)
    return torch.where(r < 0, r + cells, r).clamp(0, cells - 1)


def receiver_buckets_plain(receivers: torch.Tensor, n: int):
    """The twin of the bucketing kernel (``receiver_buckets``): (cells,
    order, starts), int32 (T,), (T,) and (n + 1,): the normalized cells,
    the rows sorted by their cell's x-plane (stably) and plane b's rows
    at order[starts[b]:starts[b + 1]] (``receiver_csr`` on tensors)."""
    cells = normalize_receivers(receivers, n)
    plane = cells // (n * n)
    order = torch.argsort(plane, stable=True)
    starts = torch.searchsorted(plane[order],
                                torch.arange(n + 1, device=plane.device))
    return (cells.to(torch.int32), order.to(torch.int32),
            starts.to(torch.int32))


def receiver_csr(cells, n: int):
    """The per-track receivers bucketed by plane, as the field plane
    kernel takes them, in NumPy (the host reference of the bucketing
    kernel): (order, starts), order the rows (int32) sorted by their
    cell's x-plane (stably), starts (n + 1 ints) such that plane b's
    block writes rows order[starts[b]:starts[b + 1]]. Takes normalized
    cells (``normalize_receivers``); raises on a cell outside the n^3
    grid."""
    cells = np.asarray(cells, np.int64)
    if cells.size and (cells.min() < 0 or cells.max() >= n ** 3):
        raise ValueError(f"receiver_csr: a receiver cell lies outside the "
                         f"{n}^3 grid")
    plane = cells // (n * n)
    order = np.argsort(plane, kind="stable").astype(np.int32)
    starts = np.searchsorted(plane[order], np.arange(n + 1))
    return order, [int(v) for v in starts]

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
    return fdtd3d_field_from_source(source_row(x), p, vx, vy, vz, x.shape[0],
                                    flat_cell(source, n),
                                    flat_cell(receiver, n), receivers)


def _cell(flat: int, n: int) -> Cell:
    return tuple(int(c) for c in np.unravel_index(flat, (n, n, n)))


def fdtd3d_field_from_source(src, p, vx, vy, vz, tracks: int,
                             src_cell: int, rcv_cell: int,
                             receivers: Optional[torch.Tensor] = None):
    """``fdtd3d_block_field_plain`` from the source row ``src`` (S,) and
    the flat source and receiver cells: the CPU implementation of the
    ``gpuab`` field operator (``ops/gpuab.py``), which takes those."""
    n = p.shape[0]
    source, s = _cell(src_cell, n), src.shape[0]
    p, vx, vy, vz = p.clone(), vx.clone(), vy.clone(), vz.clone()
    boundary = boundary_mask(n, p.device)
    cells = (normalize_receivers(receivers, n) if receivers is not None
             else torch.tensor([rcv_cell], device=p.device))
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
    n = p.shape[0]
    return fdtd3d_div_from_source(source_row(x), p, div, x.shape[0],
                                  flat_cell(source, n), flat_cell(receiver, n))


def fdtd3d_div_from_source(src, p, div, tracks: int, src_cell: int,
                           rcv_cell: int):
    """``fdtd3d_block_div_plain`` from the source row ``src`` (S,) and the
    flat source and receiver cells: the CPU implementation of the
    ``gpuab`` FDTD operators (``ops/gpuab.py``), which take those."""
    n = p.shape[0]
    source, receiver = _cell(src_cell, n), _cell(rcv_cell, n)
    s = src.shape[0]
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
    """The kernels' library for its queries and the barrier probe (the
    kernels launch through the ``gpuab`` operators)."""
    from gpuaudiobench_tpu_torch.utils.build import load

    return bind(load("fdtd3d"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of csrc/fdtd3d.cu's C interface
    on a loaded library (once); returns it. The launch entries are
    declared for the builds of ``tools/fdtd_stages``, which launch them
    alone."""
    if lib.fdtd_planes_capacity.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        sig = {
            "fdtd_div_planes_launch": [p] * 8 + [i] * 5 + [f] * 5 + [ip, i, p],
            "fdtd_field_planes_launch": ([p] * 15 + [i] * 5 + [f] * 4
                                         + [ip, i, p]),
            "fdtd_receiver_buckets_launch": [p, i, i, p, p, p, p],
            "fdtd_field_planes_capacity": [i],
            "fdtd_div_cluster_launch": [p] * 6 + [i] * 5 + [f] * 5 + [ip, i, p],
            "fdtd_planes_capacity": [i],
            "fdtd_cluster_occupancy": [i, ip, i],
            "fdtd_cluster_probe_launch": [i, i, i, p],
            "fdtd_cluster_probe_occupancy": [i, i],
        }
        for name, args in sig.items():
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        lib.fdtd_cluster_smem.argtypes = [i, ip, i]
        lib.fdtd_cluster_smem.restype = ctypes.c_longlong
        for name in ("fdtd_planes_smem", "fdtd_field_planes_smem"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _on_cuda(x, fn: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: a route-specific launcher takes CUDA "
                         f"tensors, got {x.device}")


def _div_op(x, p, div, n, source, receiver, plan: FdtdPlan):
    """The divergence form on ``plan``'s route, through
    ``torch.ops.gpuab.fdtd_div_{cluster,planes}_launch`` (the CPU twin
    while a CPU program is traced): (out, p', div'). The schedule's
    ranges go in as ints, which an export bakes into the program."""
    name = ("fdtd_div_cluster_launch" if plan.route == "cluster"
            else "fdtd_div_planes_launch")
    return gpuab.call(
        name, source_row(x), p, div, x.shape[0], flat_cell(source, n),
        flat_cell(receiver, n), K1, K2, C6, ABSORB, F_OUTPUT_SCALE,
        range_starts(plan), counts=KERNEL_LAUNCHES,
        key="fdtd3d_div" if plan.route == "cluster" else "fdtd3d_div_coop")


def receiver_buckets(receivers: torch.Tensor, n: int):
    """(cells, order, starts) of per-track receivers in an n^3 grid, as
    the field plane kernel takes them (``receiver_buckets_plain``): on a
    CUDA tensor one launch of the bucketing kernel through
    ``torch.ops.gpuab.fdtd_receiver_buckets``, on the stream, with no host
    read of the receivers (so a CUDA graph captures it); on a CPU tensor
    the twin (the operator while a CPU program is traced)."""
    fn = "receiver_buckets"
    if (receivers.dtype != torch.int32 or receivers.dim() != 1
            or receivers.shape[0] == 0 or not receivers.is_contiguous()):
        raise ValueError(f"{fn}: receivers must be a contiguous int32 "
                         f"(tracks,) tensor, got {receivers.dtype} "
                         f"{tuple(receivers.shape)}")
    if not 1 <= n <= FIELD_MAX_PLANES:
        raise ValueError(f"{fn}: no bucketing kernel for an {n}^3 grid")
    if receivers.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for {receivers.device}")
    if not gpuab.use_op(receivers.device):
        return receiver_buckets_plain(receivers, n)
    return gpuab.call("fdtd_receiver_buckets", receivers, n,
                      counts=KERNEL_LAUNCHES, key="fdtd3d_receiver_buckets")


def _field_op(x, p, vx, vy, vz, n, source, receiver, receivers,
              plan: FdtdPlan):
    """The field form on ``plan``'s planes through
    ``torch.ops.gpuab.fdtd_field_planes_launch`` (the CPU twin while a CPU
    program is traced): (out, p', vx', vy', vz'). Per-track receivers are
    bucketed by plane on the device first (``receiver_buckets``), and
    their normalized cells, order and plane starts go in as tensors."""
    buckets = ((None, None, None) if receivers is None
               else receiver_buckets(receivers, n))
    return gpuab.call(
        "fdtd_field_planes_launch", source_row(x), p, vx, vy, vz, *buckets,
        x.shape[0], flat_cell(source, n), flat_cell(receiver, n), K1, K2,
        ABSORB, F_OUTPUT_SCALE, range_starts(plan), counts=KERNEL_LAUNCHES,
        key="fdtd3d_field")


def _check_div(x, p, div, source, receiver, fn):
    return _check(x, [("p", p, (0, 0, 0)), ("div", div, (0, 0, 0))], source,
                  receiver, None, fn)


def _check_field(x, p, vx, vy, vz, source, receiver, receivers, fn):
    return _check(x, [("p", p, (0, 0, 0)), ("vx", vx, (1, 0, 0)),
                      ("vy", vy, (0, 1, 0)), ("vz", vz, (0, 0, 1))],
                  source, receiver, receivers, fn)


def fdtd3d_block_div(x, p, div, source: Cell = SOURCE,
                     receiver: Cell = RECEIVER):
    """Divergence-form block: (out (T, S), p', div'); the grid size rides
    p.shape (room + 2 ghost cells)."""
    n = _check_div(x, p, div, source, receiver, "fdtd3d_block_div")
    if not gpuab.use_op(x.device):
        return fdtd3d_block_div_plain(x, p, div, source, receiver)
    return _div_op(x, p, div, n, source, receiver, fdtd_schedule(n, "div"))


def fdtd3d_block_field(x, p, vx, vy, vz, source: Cell = SOURCE,
                       receiver: Cell = RECEIVER,
                       receivers: Optional[torch.Tensor] = None):
    """Field-form block: (out (T, S), p', vx', vy', vz'); ``receivers``
    (int32 (T,) flat cells) gives each track its own receiver, a cell
    outside the grid read as the JAX package reads it (a negative cell
    wrapped once by n^3, then clamped to the grid)."""
    n = _check_field(x, p, vx, vy, vz, source, receiver, receivers,
                     "fdtd3d_block_field")
    if not gpuab.use_op(x.device):
        return fdtd3d_block_field_plain(x, p, vx, vy, vz, source, receiver,
                                        receivers)
    return _field_op(x, p, vx, vy, vz, n, source, receiver, receivers,
                     fdtd_schedule(n, "field"))


def fdtd3d_block_div_cluster(x, p, div, source: Cell = SOURCE,
                             receiver: Cell = RECEIVER):
    """``fdtd3d_block_div`` on the cluster route; raises when the grid
    does not fit a cluster."""
    fn = "fdtd3d_block_div_cluster"
    n = _check_div(x, p, div, source, receiver, fn)
    _on_cuda(x, fn)
    plan = fdtd_schedule(n, "div")
    if plan.route != "cluster":
        raise ValueError(f"{fn}: an {n}^3 grid does not fit a cluster")
    return _div_op(x, p, div, n, source, receiver, plan)


def fdtd3d_block_div_coop(x, p, div, source: Cell = SOURCE,
                          receiver: Cell = RECEIVER):
    """``fdtd3d_block_div`` on the plane route (``plane_schedule``), at
    any room, including those the cluster route takes."""
    fn = "fdtd3d_block_div_coop"
    n = _check_div(x, p, div, source, receiver, fn)
    _on_cuda(x, fn)
    return _div_op(x, p, div, n, source, receiver, plane_schedule(n))


def cluster_probe(blocks: int, smem_bytes: int, syncs: int, device) -> None:
    """Launch ``syncs`` cluster barriers alone, in one cluster of
    ``blocks`` blocks of the cluster kernels' size with ``smem_bytes`` of
    shared memory each: a measurement of the barrier (not counted in
    KERNEL_LAUNCHES)."""
    lib = _lib()
    device = torch.device(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fdtd_cluster_probe_launch(syncs, blocks, smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fdtd_cluster_probe_launch failed: CUDA error "
                           f"{err}")


def cluster_occupancy(blocks: int, smem_bytes: int, device) -> int:
    """Clusters of ``blocks`` blocks with ``smem_bytes`` each that the card
    holds at once (``cudaOccupancyMaxActiveClusters`` on the barrier
    probe): 0 when such a cluster cannot be scheduled."""
    lib = _lib()
    with torch.cuda.device(torch.device(device)):
        got = lib.fdtd_cluster_probe_occupancy(blocks, smem_bytes)
    if got < 0:
        raise RuntimeError(f"fdtd_cluster_probe_occupancy failed: CUDA error "
                           f"{-got}")
    return got
