"""Streaming neural amp-model inference: the dilated TCN (NeuralAmp) and
the one-layer LSTM (NeuralAmpLSTM).

PyTorch counterpart of ``gpuaudiobench_tpu/ops/neuralamp.py``. Both
architectures are plain GEMMs and elementwise ops there, so they are
plain PyTorch here: cuBLAS through ``torch.baddbmm`` / ``addmm``, and
``torch._int_mm`` for the int8 taps (``ops/speedoflight.py:matmul_int8``
checks its shape rules).

* The TCN (``tcn_block``) is a straight-line stack of L dilated causal
  layers, h <- h + tanh(sum_j ext_j @ w_j + b), where ext is the layer's
  carried tail of (K-1)*2^l samples followed by the block and ext_j its
  view delayed by (K-1-j)*2^l samples. Each tap is one batched GEMM over
  the tracks on the strided view, so no tap copies its operand (int8's
  does: ``_int_mm`` takes row-major rows). f32 computes in full FP32
  (TF32 off); the JAX package's f32 mode is ``Precision.HIGH``. bf16
  keeps activations and tails in bf16 and sums every product in f32
  (``out_dtype=torch.float32``). int8 quantizes each layer's input to one
  per-tensor scale on the device (on dp ranks, the max |x| of the whole
  sharded tensor: each rank's max reduced over the ranks, as XLA reduces
  the JAX package's) and each tap to per-output-channel
  scales at set-up (``cast_params``); the tap matrices are stored
  column-major, the layout cuBLAS's int8 GEMM runs fastest on. Where C is
  no multiple of 8 (``torch._int_mm`` on CUDA takes K and N in multiples
  of 8), the tap matrices are zero-padded to the next multiple at set-up
  and each layer's quantized input once a layer; the zero channels add
  nothing to the int32 sums and leave the max-|x| scale as it is, and the
  padded output channels are sliced away before the f32 epilogue. At
  C % 8 == 0 nothing is padded.
* The LSTM (``lstm_block``) is 512 dependent steps of a (T, H) x (H, 4H)
  GEMM and a few elementwise ops, with (h, c) carried in f32 and the
  gates in the order i, f, g, o. The input term x_t * w[0] + b of every
  sample is computed before the loop and the h_t @ w_out output after
  it, in one op each: the same sums, in another order of addition. On a
  CUDA device a block runs only as a replay of a captured CUDA graph
  (``lstm_runner``, ``harness/graph.py``); each replay is counted in
  ``GRAPH_REPLAYS``. The eager ``lstm_block`` is what the CPU runs and
  what the graph is held against.

The host functions (the schedules, the seeded weights, the f64 goldens
``tcn_reference`` and ``lstm_reference``) are copies of the JAX
package's, in NumPy.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpuaudiobench_tpu_torch.harness.graph import CapturedBlock
from gpuaudiobench_tpu_torch.ops.speedoflight import (
    INT_MM_MULTIPLE,
    matmul_int8,
)

KERNEL = 3  # tap count per dilated layer (micro-TCN's standard k)

# A reduction of a 0-d tensor over the ranks that shard it (``pmax``).
MaxReduce = Callable[[torch.Tensor], torch.Tensor]

# LSTM blocks run as graph replays, counted where the replay is issued
# (chip_smoke.py reads the count to prove the main path replayed graphs).
GRAPH_REPLAYS: Dict[str, int] = {"lstm_block": 0}

F32 = torch.float32
BF16 = torch.bfloat16


def dilations(layers: int) -> List[int]:
    """Dilation schedule 1, 2, 4, ... (receptive field (K-1)(2^L-1)+1)."""
    return [1 << l for l in range(layers)]


def context_lengths(layers: int) -> List[int]:
    """Per-layer carried-tail lengths (K-1)*dilation."""
    return [(KERNEL - 1) * d for d in dilations(layers)]


def receptive_field(layers: int) -> int:
    return (KERNEL - 1) * ((1 << layers) - 1) + 1


def steady_blocks(layers: int, block_size: int) -> int:
    """Blocks until the output of a repeated input block is exactly
    periodic: once (k-1)*B covers the total carried context, every tail
    holds true history of the B-periodic activation stream."""
    total_ctx = sum(context_lengths(layers))
    return -(-total_ctx // block_size) + 1


def init_params(seed: int, channels: int, layers: int) -> Dict[str, np.ndarray]:
    """Seeded float32 network weights, generated on the host. Tap
    matrices are uniform with variance 1/(KERNEL*channels) so each
    residual branch adds unit-order variance; w_in / w_out are
    unit-scale."""
    rng = np.random.default_rng(seed)
    s_tap = float(np.sqrt(3.0 / (KERNEL * channels)))
    p: Dict[str, np.ndarray] = {
        "w_in": rng.uniform(-1, 1, channels).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, channels).astype(np.float32),
        "w_out": rng.uniform(-1, 1, channels).astype(np.float32)
        / np.float32(channels),
        "b_out": np.float32(rng.uniform(-0.1, 0.1)),
    }
    for l in range(layers):
        p[f"w{l}"] = rng.uniform(
            -s_tap, s_tap, (KERNEL, channels, channels)
        ).astype(np.float32)
        p[f"b{l}"] = rng.uniform(-0.1, 0.1, channels).astype(np.float32)
    return p


def param_bytes(channels: int, layers: int, dtype: str) -> int:
    if dtype == "int8":
        # 1-byte tap stacks + f32 per-output-channel scales and biases;
        # w_in / w_out / b_out stay f32.
        return (layers * (KERNEL * channels * channels + 2 * channels * 4)
                + (3 * channels + 1) * 4)
    per = 2 if dtype == "bf16" else 4
    return (layers * (KERNEL * channels * channels + channels) + 3 * channels
            + 1) * per


def activation_dtype(dtype: str) -> torch.dtype:
    """The TCN's activation and tail storage: bf16 for the bf16 and int8
    modes (int8 quantizes GEMM operands, not storage), else f32."""
    return BF16 if dtype in ("bf16", "int8") else F32


def init_tails(tracks: int, channels: int, layers: int, dtype: str = "f32",
               device: torch.device = torch.device("cpu")
               ) -> Tuple[torch.Tensor, ...]:
    """Zero carried state: one (T, (K-1)*2^l, C) tail per layer, in the
    activation dtype."""
    return tuple(
        torch.zeros((tracks, ctx, channels), dtype=activation_dtype(dtype),
                    device=device)
        for ctx in context_lengths(layers))


def _put(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def cast_params(params: Dict[str, np.ndarray], dtype: str,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """``init_params`` arrays as tensors on ``device`` for the compute
    dtype. bf16 casts the tap stacks and w_out. int8 quantizes each
    layer's tap stack per output channel (scale = max|w[:, :, d]| / 127,
    ``w{l}`` int8 plus ``w{l}_s`` f32 (C,)), each tap matrix stored
    column-major (a (K, C_in, C_out) view of (K, C_out, C_in) memory) and
    zero-padded in C_in and C_out to ``int8_width(C)``; w_out stays f32.
    w_in and the biases stay f32."""
    out = {}
    for k, v in params.items():
        if k.startswith("w") and k != "w_in" and dtype != "f32":
            if dtype == "int8" and k != "w_out":
                s = np.maximum(
                    np.abs(v).max(axis=(0, 1)), 1e-12) / np.float32(127.0)
                q = np.clip(np.round(v / s), -127, 127).astype(np.int8)
                pad = int8_width(q.shape[1]) - q.shape[1]
                q = np.pad(q, ((0, 0), (0, pad), (0, pad)))
                out[k] = _put(q.transpose(0, 2, 1), device).transpose(1, 2)
                out[k + "_s"] = _put(s.astype(np.float32), device)
            elif dtype == "int8":  # w_out stays f32
                out[k] = _put(v, device)
            else:
                out[k] = _put(v, device).to(BF16)
        else:
            out[k] = _put(v, device)
    return out


def int8_width(channels: int) -> int:
    """The int8 GEMMs' K and N: ``channels`` rounded up to a multiple of
    ``INT_MM_MULTIPLE``."""
    return -(-channels // INT_MM_MULTIPLE) * INT_MM_MULTIPLE


def quantize_activation(ext: torch.Tensor,
                        reduce_max: Optional[MaxReduce] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale) of one layer input: one per-tensor scale
    max(|ext|) / 127 kept on the device, round half to even, clip.
    ``reduce_max`` takes the local max to the max over every shard of the
    tensor (``Benchmark.dp_pmax``; None: ``ext`` is the whole tensor)."""
    ext32 = ext.float()
    peak = ext32.abs().amax()
    if reduce_max is not None:
        peak = reduce_max(peak)
    s_a = torch.clamp_min(peak, 1e-12) / 127.0
    q = torch.clamp(torch.round(ext32 / s_a), -127, 127).to(torch.int8)
    return q, s_a


def _tap(acc: torch.Tensor, seg: torch.Tensor, w: torch.Tensor
         ) -> torch.Tensor:
    """acc + seg @ w, seg (T, B, C) a strided view, w (C, C), the product
    summed in f32 (bf16 operands through ``out_dtype`` on the card;
    upcast, which is exact, on the CPU). A (C,) ``acc`` (the bias) is
    broadcast into a new accumulator; a (T, B, C) one is added to in
    place."""
    wb = w.expand(seg.shape[0], *w.shape)
    out = None if acc.dim() == 1 else acc
    if seg.dtype == F32 or seg.device.type == "cpu":
        return torch.baddbmm(acc, seg.float(), wb.float(), out=out)
    return torch.baddbmm(acc, seg, wb, out_dtype=F32, out=out)


def _int8_taps(ext: torch.Tensor, w: torch.Tensor, d: int, b: int,
               reduce_max: Optional[MaxReduce] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int32 sum of the K int8 tap products of one layer, (T, B, C),
    and the activation scale (``quantize_activation``'s, with
    ``reduce_max``). ``w`` is ``cast_params``' padded stack: the quantized
    input is zero-padded to its width once, and the padded output channels
    sliced away."""
    q, s_a = quantize_activation(ext, reduce_max)
    t, c = ext.shape[0], ext.shape[2]
    width = w.shape[1]
    if width != c:
        q = F.pad(q, (0, width - c))
    acc_i = None
    for j in range(KERNEL):
        seg = q[:, j * d:j * d + b].contiguous().view(t * b, width)
        r = matmul_int8(seg, w[j])
        acc_i = r if acc_i is None else acc_i + r
    acc_i = acc_i.view(t, b, -1)
    return (acc_i if width == c else acc_i[..., :c]), s_a


def tcn_block(x: torch.Tensor, tails: Tuple[torch.Tensor, ...],
              params: Dict[str, torch.Tensor], layers: int,
              dtype: str = "f32", reduce_max: Optional[MaxReduce] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One streamed block of TCN inference: x (T, B) f32, tails the
    (T, (K-1)*2^l, C) carried layer inputs, params from ``cast_params``.
    Returns (y (T, B) f32, tails'). The inputs are not written. In int8,
    ``reduce_max`` reduces each layer's activation max over the shards of
    the tracks (``quantize_activation``); None on one rank."""
    act = activation_dtype(dtype)
    t, b = x.shape
    h = torch.tanh(x[..., None] * params["w_in"] + params["b_in"]).to(act)
    new_tails = []
    for l in range(layers):
        d = 1 << l
        ctx = (KERNEL - 1) * d
        ext = torch.cat([tails[l], h], dim=1)  # (T, B + ctx, C)
        new_tails.append(ext[:, -ctx:].clone())
        if dtype == "int8":
            acc_i, s_a = _int8_taps(ext, params[f"w{l}"], d, b,
                                    reduce_max)
            acc = (acc_i.float() * (s_a * params[f"w{l}_s"])
                   + params[f"b{l}"])
        else:
            acc = params[f"b{l}"]
            for j in range(KERNEL):
                # Tap j sees the stream delayed by (KERNEL-1-j)*d samples.
                acc = _tap(acc, ext[:, j * d:j * d + b], params[f"w{l}"][j])
        h = acc.tanh_().add_(h).to(act)  # residual block, in f32
    w_out = params["w_out"]
    flat = h.view(t * b, -1)
    if dtype == "bf16" and flat.device.type != "cpu":
        y = torch.mm(flat, w_out.view(-1, 1), out_dtype=F32).view(t, b)
    else:
        y = (flat.float() @ w_out.float()).view(t, b)
    return y + params["b_out"], tuple(new_tails)


def tcn_block_f64(
    x: np.ndarray,
    tails: Tuple[np.ndarray, ...],
    params: Dict[str, np.ndarray],
    layers: int,
) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """Float64 NumPy twin of tcn_block (the golden's single step)."""
    h = np.tanh(
        x.astype(np.float64)[..., None] * params["w_in"].astype(np.float64)
        + params["b_in"].astype(np.float64))
    b = x.shape[1]
    new_tails = []
    for l in range(layers):
        d = 1 << l
        ctx = (KERNEL - 1) * d
        ext = np.concatenate([tails[l], h], axis=1)
        new_tails.append(ext[:, -ctx:])
        acc = params[f"b{l}"].astype(np.float64)
        w = params[f"w{l}"].astype(np.float64)
        for j in range(KERNEL):
            acc = acc + ext[:, j * d:j * d + b] @ w[j]
        h = h + np.tanh(acc)
    y = h @ params["w_out"].astype(np.float64) + float(params["b_out"])
    return y, tuple(new_tails)


def tcn_reference(
    x: np.ndarray,
    k: int,
    params: Dict[str, np.ndarray],
    layers: int,
) -> np.ndarray:
    """Float64 output block k (1-indexed) of streaming the same block x
    k times from zero state, replay clamped at steady_blocks()."""
    reps = min(k, steady_blocks(layers, x.shape[1]))
    tails = tuple(
        np.zeros((x.shape[0], ctx, params["w_in"].shape[0]), np.float64)
        for ctx in context_lengths(layers))
    y = None
    for _ in range(reps):
        y, tails = tcn_block_f64(x, tails, params, layers)
    return y.astype(np.float32)


# Samples until the repeated-block output orbit converges below f64
# noise (the JAX package measured ~0.967 a sample worst-unit contraction
# at B = 512, H = 128; 4096 samples is > 2.5x what it needs).
LSTM_STEADY_SAMPLES = 4096


def lstm_steady_blocks(block_size: int) -> int:
    """Replay clamp for the LSTM golden: enough blocks that at least
    LSTM_STEADY_SAMPLES of gate contraction precede the reported one."""
    return -(-LSTM_STEADY_SAMPLES // block_size) + 1


def init_lstm_params(seed: int, hidden: int) -> Dict[str, np.ndarray]:
    """Seeded float32 LSTM weights: one recurrent layer of ``hidden``
    units (gate order i, f, g, o) packed as w (H+1, 4H) with the input
    row first, dense output, input skip; the forget-gate bias starts at
    +1."""
    rng = np.random.default_rng(seed)
    s = float(np.sqrt(3.0 / (hidden + 1)))
    b = np.zeros(4 * hidden, np.float32)
    b[hidden:2 * hidden] = 1.0
    return {
        "w": rng.uniform(-s, s, (hidden + 1, 4 * hidden)).astype(np.float32),
        "b": b,
        "w_out": (rng.uniform(-1, 1, hidden) / hidden).astype(np.float32),
        "b_out": np.float32(rng.uniform(-0.1, 0.1)),
    }


def lstm_param_bytes(hidden: int, dtype: str) -> int:
    per = 2 if dtype == "bf16" else 4
    return ((hidden + 1) * 4 * hidden + hidden) * per + 4 * hidden * 4 + 4


def cast_lstm_params(params: Dict[str, np.ndarray], dtype: str,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """``init_lstm_params`` arrays as tensors on ``device``: bf16 casts
    the GEMM operands (w, w_out); the gate biases stay f32."""
    out = {}
    for k, v in params.items():
        out[k] = _put(v, device)
        if dtype == "bf16" and k in ("w", "w_out"):
            out[k] = out[k].to(BF16)
    return out


def _gemm_into(z: torch.Tensor, a: torch.Tensor, w: torch.Tensor) -> None:
    """z += a @ w in place, summed in f32 (a, w bf16 or f32)."""
    if a.dtype == F32 or a.device.type == "cpu":
        torch.addmm(z, a.float(), w.float(), out=z)
    else:
        torch.addmm(z, a, w, out_dtype=F32, out=z)


def lstm_block(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               params: Dict[str, torch.Tensor], dtype: str = "f32"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streamed block of LSTM inference, eagerly: x (T, S) f32, (h, c)
    (T, H) f32. Returns (y (T, S), h', c'). In bf16 mode the GEMM
    operands are bf16 and the sums f32. The inputs are not written."""
    hidden = h.shape[1]
    t, s = x.shape
    w = params["w"]
    w_x, w_h = w[0].float(), w[1:]
    if w_h.device.type == "cpu":
        w_h = w_h.float()
    cast = BF16 if dtype == "bf16" else F32
    # The input term of every sample, x_t * w_x + b: (S, T, 4H).
    zx = torch.addcmul(params["b"], x.t()[..., None], w_x)
    hs = torch.empty((s, t, hidden), dtype=F32, device=x.device)
    for n in range(s):
        z = zx[n]
        _gemm_into(z, h.to(cast), w_h)
        g = torch.tanh(z[:, 2 * hidden:3 * hidden])
        z.sigmoid_()  # i, f, o (the g slot is not read again)
        c = torch.addcmul(z[:, hidden:2 * hidden] * c, z[:, :hidden], g)
        h = torch.mul(z[:, 3 * hidden:], torch.tanh(c), out=hs[n])
    # The output of every sample, h_t @ w_out + b_out + x_t (input skip).
    flat = hs.view(s * t, hidden).to(cast)
    w_out = params["w_out"]
    if cast == BF16 and flat.device.type != "cpu":
        yt = torch.mm(flat, w_out.view(-1, 1), out_dtype=F32)
    else:
        yt = flat.float() @ w_out.float().view(-1, 1)
    y = (yt.view(s, t) + params["b_out"] + x.t()).t().contiguous()
    return y, h.clone(), c


def lstm_runner(params: Dict[str, torch.Tensor], dtype: str,
                x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                ) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """The LSTM block for one tier, over inputs of its own shaped like
    (x, h, c): ``run(x, h, c) -> (y, h', c')``, or ``run()`` on its inputs
    as they stand. On a CUDA device every call is one replay of a
    ``CapturedBlock`` that owns copies of (x, h, c) (counted in
    ``GRAPH_REPLAYS``); the outputs are the graph's, rewritten by the
    next replay. On the CPU it is ``lstm_block`` on the given tensors."""

    def block(x, h, c):
        return lstm_block(x, h, c, params, dtype)

    if x.device.type == "cuda":
        return CapturedBlock(block, [t.clone() for t in (x, h, c)],
                             counts=GRAPH_REPLAYS, key="lstm_block")
    if x.device.type != "cpu":
        raise ValueError(f"lstm_runner: no CUDA graph for {x.device}")
    inputs = (x, h, c)
    return lambda *args: block(*(args or inputs))


def lstm_block_f64(x, h, c, params):
    """Float64 NumPy twin of lstm_block (the golden's single block)."""

    def sig(z):
        return 1.0 / (1.0 + np.exp(-z))

    w = params["w"].astype(np.float64)
    b = params["b"].astype(np.float64)
    w_out = params["w_out"].astype(np.float64)
    b_out = float(params["b_out"])
    hidden = h.shape[1]
    t_n, s_n = x.shape
    x64 = x.astype(np.float64)
    ys = np.empty((t_n, s_n))
    for t in range(s_n):
        inp = np.concatenate([x64[:, t:t + 1], h], axis=1)
        z = inp @ w + b
        i = sig(z[:, :hidden])
        f = sig(z[:, hidden:2 * hidden])
        g = np.tanh(z[:, 2 * hidden:3 * hidden])
        o = sig(z[:, 3 * hidden:])
        c = f * c + i * g
        h = o * np.tanh(c)
        ys[:, t] = h @ w_out + b_out + x64[:, t]
    return ys, h, c


def lstm_reference(x: np.ndarray, k: int,
                   params: Dict[str, np.ndarray]) -> np.ndarray:
    """Float64 output block k (1-indexed) of streaming the same block x
    k times from zero state, replay clamped at lstm_steady_blocks()."""
    reps = min(k, lstm_steady_blocks(x.shape[1]))
    hidden = params["w_out"].shape[0]
    h = np.zeros((x.shape[0], hidden))
    c = np.zeros((x.shape[0], hidden))
    y = None
    for _ in range(reps):
        y, h, c = lstm_block_f64(x, h, c, params)
    return y.astype(np.float32)
