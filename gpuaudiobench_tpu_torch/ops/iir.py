"""Biquad IIR filters: the per-track Direct Form II recurrence.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/iir.py``, with its public
contracts: x and y are (tracks, S) track-major, a state is (tracks, 2) =
(z1, z2), a K-stage cascade's states are (K, tracks, 2), coefficients
are (5,) or (K, 5) = (b0, b1, b2, a1, a2).

  w[n] = x[n] - a1*w[n-1] - a2*w[n-2]
  y[n] = b0*w[n] + b1*w[n-1] + b2*w[n-2]

Plain PyTorch twins (what the CPU runs, and what the kernels are held
against on the card):

* ``iir_biquad_plain``: the sample loop of ``iir_biquad_xla``.
* ``iir_biquad_blockstate_plain``: the chunk products of
  ``iir_biquad_blockstate`` (``torch.matmul`` in float32).
* ``iir_cascade_plain``: a chain of single-stage plain biquads.

Four wrappers of the hand-written CUDA kernels (``csrc/iir.cu``), each
with the contract of its Pallas kernel, each reaching its kernel through
a ``torch.ops.gpuab`` operator (``ops/gpuab.py``), which an exported
program calls too. The library's ctypes handle (``_lib``) serves only
the queries the wrappers check against: ``iir_max_stages`` and the warps
a block of each cascade kernel.

* ``iir_biquad`` (``iir_biquad_pallas``),
* ``iir_biquad_blockstate`` (``iir_biquad_blockstate_pallas``),
* ``iir_cascade`` (``iir_cascade_pallas``, the systolic kernel, launched
  on ``cascade_schedule``),
* ``iir_cascade_chain`` (``iir_cascade_pallas_chain``, its oracle; the
  port's chain wrapper runs the chain kernel at every track count, on
  the route ``chain_schedule`` picks).

A wrapper runs the plain twin only because its tensors lie on the CPU
(and calls its operator, whose CPU implementation is the twin, while a
CPU program is traced). On a CUDA tensor it launches its kernel or
raises; it never falls back.
New states always go to fresh tensors: the input state is never written.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from gpuaudiobench_tpu_torch.ops import gpuab

# Launches of each CUDA kernel, counted by its wrapper where it launches
# it (chip_smoke.py reads them to prove the main path used the kernels).
KERNEL_LAUNCHES: Dict[str, int] = {
    "iir_biquad": 0,
    "iir_biquad_blockstate": 0,
    "iir_cascade": 0,
    "iir_cascade_chain": 0,
}
# Launches of the chain kernel by route (each also counts once under
# KERNEL_LAUNCHES["iir_cascade_chain"]).
CHAIN_ROUTE_LAUNCHES: Dict[str, int] = {"tma": 0, "staged": 0}

Pair = Tuple[torch.Tensor, torch.Tensor]


def iir_biquad_plain(x: torch.Tensor, coeffs: torch.Tensor,
                     state: torch.Tensor) -> Pair:
    """x (T, S), coeffs (5,), state (T, 2) -> (y (T, S), state')."""
    b0, b1, b2, a1, a2 = (coeffs[i] for i in range(5))
    xt = x.t().contiguous()
    yt = torch.empty_like(xt)
    z1, z2 = state[:, 0], state[:, 1]
    for n in range(xt.shape[0]):
        w = xt[n] - a1 * z1 - a2 * z2
        yt[n] = b0 * w + b1 * z1 + b2 * z2
        z1, z2 = w, z1
    return yt.t().contiguous(), torch.stack([z1, z2], dim=1)


def iir_cascade_plain(x: torch.Tensor, coeffs: torch.Tensor,
                      states: torch.Tensor) -> Pair:
    """x (T, S), coeffs (K, 5), states (K, T, 2) -> (y, states'): stage k
    filters stage k-1's output."""
    y, zs = x, []
    for k in range(coeffs.shape[0]):
        y, z = iir_biquad_plain(y, coeffs[k], states[k])
        zs.append(z)
    return y, torch.stack(zs)


def iir_biquad_blockstate_plain(x: torch.Tensor, coeffs: torch.Tensor,
                                taps: torch.Tensor, u: torch.Tensor,
                                state: torch.Tensor) -> Pair:
    """The block-state form: per m-sample chunk,
    w = x_chunk @ taps^T + state @ u^T, y = b0*w + b1*w[-1] + b2*w[-2],
    state' = (w[m-1], w[m-2]). Only b0, b1, b2 of coeffs are read (a1,
    a2 live in the tables). S must be a multiple of m."""
    b0, b1, b2 = coeffs[0], coeffs[1], coeffs[2]
    m = taps.shape[0]
    tracks, s = x.shape
    _check_block_m(s, m)
    y = torch.empty_like(x)
    carry = state
    for n0 in range(0, s, m):
        w = x[:, n0:n0 + m] @ taps.t() + carry @ u.t()
        wm1 = torch.cat([carry[:, :1], w[:, :-1]], dim=1)
        wm2 = torch.cat([carry[:, 1:2], wm1[:, :-1]], dim=1)
        y[:, n0:n0 + m] = b0 * w + b1 * wm1 + b2 * wm2
        carry = torch.stack([w[:, m - 1], w[:, m - 2]], dim=1)
    return y, carry


def blockstate_tables(coeffs, m: int):
    """Host-side tables of the m-sample block-state form, derived in
    float64 and stored as float32: (taps (m, m) lower-triangular
    Toeplitz of the w-impulse response p_k = (A^k)[0, 0], u (m, 2) rows
    of A^{j+1}[0, :]) with A = [[-a1, -a2], [1, 0]]."""
    _, _, _, a1, a2 = (float(c) for c in coeffs)
    a = np.array([[-a1, -a2], [1.0, 0.0]], np.float64)
    powers = [np.eye(2)]
    for _ in range(m):
        powers.append(a @ powers[-1])
    p = np.array([powers[k][0, 0] for k in range(m)])
    taps = np.zeros((m, m))
    for j in range(m):
        taps[j, : j + 1] = p[j::-1]
    u = np.stack([powers[j + 1][0, :] for j in range(m)])
    return taps.astype(np.float32), u.astype(np.float32)


def blockstate_effective_m(s: int, block_m: int) -> int:
    """Largest divisor of s in [2, block_m]; raises if there is none
    (the carried state is w's last TWO rows, so m >= 2)."""
    m = min(block_m, s)
    while m > 1 and s % m != 0:
        m -= 1
    if m < 2:
        raise ValueError(
            f"blockstate needs a buffer-size divisor in "
            f"[2, {min(block_m, s)}]; buffer_size {s} has none -- "
            "use --iirForm scan")
    return m


def _check_block_m(s: int, m: int) -> None:
    if m < 2 or s % m != 0:
        raise ValueError(f"blockstate: m ({m}) must be >= 2 and divide S ({s})")


def _check(name: str, x: torch.Tensor, shapes) -> torch.device:
    """Every tensor float32, contiguous, of its shape and on x's device,
    and that device one with an implementation."""
    dev = x.device
    for label, t, shape in shapes:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected "
                f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, x on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name}: x must be (tracks, S) with both > 0")
    return dev


def _lib() -> ctypes.CDLL:
    from gpuaudiobench_tpu_torch.utils.build import load

    lib = load("iir")
    if lib.iir_max_stages.argtypes is None:
        i = ctypes.c_int
        lib.iir_cascade_warps.argtypes = []
        lib.iir_cascade_warps.restype = i
        lib.iir_chain_warps.argtypes = []
        lib.iir_chain_warps.restype = i
        for fn, want in ((lib.iir_cascade_warps, CASCADE_WARPS),
                         (lib.iir_chain_warps, CHAIN_WARPS)):
            if fn() != want:
                raise RuntimeError(
                    f"csrc/iir.cu {fn.__name__} is {fn()}, ops/iir.py "
                    f"schedules {want}")
        lib.iir_max_stages.argtypes = []
        lib.iir_max_stages.restype = i
    return lib


def iir_biquad(x: torch.Tensor, coeffs: torch.Tensor,
               state: torch.Tensor) -> Pair:
    """Same contract as ``iir_biquad_pallas``: (y (T, S), state')."""
    tracks, s = x.shape
    dev = _check("iir_biquad", x, [("x", x, (tracks, s)),
                                   ("coeffs", coeffs, (5,)),
                                   ("state", state, (tracks, 2))])
    if not gpuab.use_op(dev):
        return iir_biquad_plain(x, coeffs, state)
    return gpuab.call("iir_biquad_launch", x, coeffs, state,
                      counts=KERNEL_LAUNCHES, key="iir_biquad")


def iir_biquad_blockstate(x: torch.Tensor, coeffs: torch.Tensor,
                          taps: torch.Tensor, u: torch.Tensor,
                          state: torch.Tensor) -> Pair:
    """Same contract as ``iir_biquad_blockstate_pallas``; m is
    taps.shape[0], which must divide S (and be at most 128 on CUDA)."""
    tracks, s = x.shape
    m = taps.shape[0] if taps.dim() == 2 else 0
    dev = _check("iir_biquad_blockstate", x, [
        ("x", x, (tracks, s)), ("coeffs", coeffs, (5,)),
        ("taps", taps, (m, m)), ("u", u, (m, 2)),
        ("state", state, (tracks, 2))])
    _check_block_m(s, m)
    if not gpuab.use_op(dev):
        return iir_biquad_blockstate_plain(x, coeffs, taps, u, state)
    if dev.type == "cuda" and m > 128:
        raise ValueError(f"the CUDA blockstate kernel takes m <= 128, got {m}")
    return gpuab.call("iir_blockstate_launch", x, coeffs, taps, u, state,
                      counts=KERNEL_LAUNCHES, key="iir_biquad_blockstate")


# Warps per block of the systolic cascade kernel (csrc/iir.cu kCsWarps;
# _lib checks the built library agrees).
CASCADE_WARPS = 4
CASCADE_CHUNK = 32  # samples per shared-memory chunk tile
CASCADE_QUAD = 4    # steps per quad: one 16-byte read and write a lane


@dataclass(frozen=True)
class CascadeSchedule:
    """Launch geometry of the systolic cascade kernel for one shape.

    One warp owns 32 tracks (``grid`` blocks of ``warps`` warps). At step
    t stage k updates sample t - k. ``warmup``, ``steady`` and ``drain``
    are half-open step ranges: the K - 1 warm-up steps and the drain run
    with the live mask 0 <= t - k < S, the steady steps (whole quads of 4,
    each stage live at every one of them) without it. Quad q = (t - (K -
    1)) // 4 emits output samples 4q .. 4q + 3, so ``drain`` ends at
    K - 1 + 4 * ceil(S / 4) (up to 3 steps past S + K - 1, with every
    stage dead). ``chunks`` is the number of 32-sample tiles a warp moves.
    """

    grid: int
    warps: int
    warmup: Tuple[int, int]
    steady: Tuple[int, int]
    drain: Tuple[int, int]
    chunks: int


def cascade_schedule(tracks: int, s: int, k: int) -> CascadeSchedule:
    """The systolic cascade's schedule for (tracks, S) and K stages."""
    if tracks < 1 or s < 1 or k < 1:
        raise ValueError(f"cascade_schedule: tracks {tracks}, S {s} and K "
                         f"{k} must all be >= 1")
    lag = k - 1
    steady_quads = max(0, (s - lag) // CASCADE_QUAD)
    quads = -(-s // CASCADE_QUAD)
    steady_end = lag + CASCADE_QUAD * steady_quads
    return CascadeSchedule(
        grid=-(-tracks // (32 * CASCADE_WARPS)), warps=CASCADE_WARPS,
        warmup=(0, lag),
        steady=(lag, steady_end),
        drain=(steady_end, lag + CASCADE_QUAD * quads),
        chunks=-(-s // CASCADE_CHUNK))


# Warps per block of the chain cascade kernel (csrc/iir.cu kChWarps).
CHAIN_WARPS = 4
CHAIN_BOX = (32, 32)     # a chunk tile: (samples, tracks), 128-byte rows
CHAIN_SWIZZLE = 128      # bytes: the TMA's 128-byte swizzle of a tile
CHAIN_ROUTES = ("tma", "staged")  # the C entry's route 0 and 1


@dataclass(frozen=True)
class ChainSchedule:
    """Launch geometry of the chain cascade kernel for one shape.

    ``grid`` blocks of ``warps`` warps, a warp 32 tracks; ``chunks``
    32-sample chunk tiles a warp. ``route`` "tma" fills and stores the
    tiles by TMA on tensor maps of x and y that ``csrc/iir.cu`` encodes
    as ``global_dims`` (S, tracks), innermost first, rows ``row_pitch``
    bytes apart, boxes of ``box`` elements, a ``swizzle``-byte swizzle:
    TMA takes a row pitch that is a multiple of 16 bytes (S % 4 == 0) and
    a 16-byte aligned x (y comes from the wrapper's allocator, aligned).
    Otherwise "staged": the warp's lanes fill and store each tile element
    by element. The route is picked here, before the launch; the C side
    refuses a TMA route that S or the pointers do not allow.
    """

    route: str
    grid: int
    warps: int
    chunks: int
    global_dims: Tuple[int, int]
    row_pitch: int
    box: Tuple[int, int]
    swizzle: int


def chain_schedule(tracks: int, s: int, x_ptr: int = 0) -> ChainSchedule:
    """The chain cascade's schedule for (tracks, S) with x at x_ptr (while
    a program is traced x has no address yet: its operator then applies
    the same rule to the pointer it launches on)."""
    if tracks < 1 or s < 1:
        raise ValueError(f"chain_schedule: tracks {tracks} and S {s} must "
                         "both be >= 1")
    return ChainSchedule(
        route="tma" if s % 4 == 0 and x_ptr % 16 == 0 else "staged",
        grid=-(-tracks // (32 * CHAIN_WARPS)), warps=CHAIN_WARPS,
        chunks=-(-s // CHAIN_BOX[0]), global_dims=(s, tracks),
        row_pitch=4 * s, box=CHAIN_BOX, swizzle=CHAIN_SWIZZLE)


def _cascade_args(kernel: str, x, coeffs, states):
    """Checks the cascade contract; returns (tracks, S, K, device)."""
    tracks, s = x.shape
    k = coeffs.shape[0] if coeffs.dim() == 2 else 0
    dev = _check(kernel, x, [("x", x, (tracks, s)),
                             ("coeffs", coeffs, (k, 5)),
                             ("states", states, (k, tracks, 2))])
    if k == 0:
        raise ValueError(f"{kernel}: needs at least one stage")
    return tracks, s, k, dev


def _check_depth(kernel: str, k: int) -> None:
    max_k = _lib().iir_max_stages()
    if k > max_k:
        raise ValueError(
            f"{kernel}: the CUDA kernels take at most {max_k} stages, got {k}")


def iir_cascade(x: torch.Tensor, coeffs: torch.Tensor,
                states: torch.Tensor) -> Pair:
    """Same contract as ``iir_cascade_pallas`` (the systolic kernel):
    x (T, S), coeffs (K, 5), states (K, T, 2) -> (y, states')."""
    tracks, s, k, dev = _cascade_args("iir_cascade", x, coeffs, states)
    if not gpuab.use_op(dev):
        return iir_cascade_plain(x, coeffs, states)
    if dev.type == "cuda":
        _check_depth("iir_cascade", k)
    sc = cascade_schedule(tracks, s, k)
    return gpuab.call("iir_cascade_launch", x, coeffs, states, sc.grid,
                      sc.steady[1], sc.drain[1], sc.chunks,
                      counts=KERNEL_LAUNCHES, key="iir_cascade")


def iir_cascade_chain(x: torch.Tensor, coeffs: torch.Tensor,
                      states: torch.Tensor) -> Pair:
    """Same contract as ``iir_cascade_pallas_chain`` (each sample through
    every stage before the next): the oracle of ``iir_cascade``. On CUDA
    the kernel runs on the route ``chain_schedule`` picks (both routes
    give the same bits)."""
    tracks, s, k, dev = _cascade_args("iir_cascade_chain", x, coeffs,
                                      states)
    if not gpuab.use_op(dev):
        return iir_cascade_plain(x, coeffs, states)
    if dev.type == "cuda":
        _check_depth("iir_cascade_chain", k)
    if gpuab.tracing():
        sc, route = chain_schedule(tracks, s), -1
    else:
        sc = chain_schedule(tracks, s, x.data_ptr())
        route = CHAIN_ROUTES.index(sc.route)
    out = gpuab.call("iir_cascade_chain_launch", x, coeffs, states, route,
                     sc.grid, sc.chunks, counts=KERNEL_LAUNCHES,
                     key="iir_cascade_chain")
    if route >= 0:
        CHAIN_ROUTE_LAUNCHES[sc.route] += 1
    return out
