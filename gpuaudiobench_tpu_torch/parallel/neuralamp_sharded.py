"""Tensor-parallel NeuralAmp: the TCN's channel axis and the LSTM's
hidden axis over a mesh axis.

PyTorch counterpart of ``gpuaudiobench_tpu/parallel/neuralamp_sharded.py``,
in the f32 mode, full FP32 (the JAX package's f32 contracts at
``Precision.HIGH``: the divergence ``ops/neuralamp.py`` records).

* The TCN is Megatron's column-parallel stack: each rank owns C/n output
  channels of every tap matrix, bias and carried tail. Per layer it
  all-gathers the layer input's channel shards (the contraction needs
  every input channel), contracts against its (K, C, C/n) column shard
  and applies tanh and the residual locally; the output 1x1 conv is
  row-parallel, finished by one psum.
* The LSTM shards the hidden units: each rank owns H/n units, all four
  gates of each (the (H+1, 4H) gate matrix regrouped to (H+1, 4, H)
  before the split, ``shard_lstm_params``), and its slice of (h, c). The
  gate GEMM needs the whole previous h, so every sample all-gathers it;
  the dense output is row-parallel, one psum after the block's samples.

Parameters come in as ``ops/neuralamp.py:cast_params`` /
``cast_lstm_params`` give them (f32) and are split by ``shard_tcn`` /
``shard_lstm_params``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gpuaudiobench_tpu_torch.ops.neuralamp import KERNEL, _tap
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel.mesh import Mesh


def _cols(n: int, mesh: Mesh, axis: str) -> slice:
    k = n // mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    return slice(i * k, (i + 1) * k)


def shard_tcn(params: Dict[str, torch.Tensor], tails, layers: int,
              mesh: Mesh, axis: str = "tp"):
    """The calling rank's channel shards: (params, tails)."""
    c = params["w_in"].shape[0]
    cols = _cols(c, mesh, axis)
    out = {"w_in": params["w_in"][cols], "b_in": params["b_in"][cols],
           "w_out": params["w_out"][cols], "b_out": params["b_out"]}
    for l in range(layers):
        out[f"w{l}"] = params[f"w{l}"][:, :, cols].contiguous()
        out[f"b{l}"] = params[f"b{l}"][cols]
    return out, tuple(t[:, :, cols].contiguous() for t in tails)


def make_neuralamp_tp_block(mesh: Mesh, layers: int, axis: str = "tp"):
    """Returns fn(x, tails, params) -> (y, tails'): x and y (T, B) whole
    on every rank, tails and params the rank's channel shards
    (``shard_tcn``)."""

    def local_block(x, tails, params):
        b = x.shape[1]
        # Input 1x1 conv: w_in is channel-sharded, so h is born local.
        h = torch.tanh(x[..., None] * params["w_in"] + params["b_in"])
        new_tails = []
        for l in range(layers):
            d = 1 << l
            ctx = (KERNEL - 1) * d
            ext = torch.cat([tails[l], h], dim=1)
            new_tails.append(ext[:, -ctx:].clone())
            # The contraction needs every input channel: gather the shards.
            full = col.all_gather(ext, mesh, axis, dim=2)
            acc = params[f"b{l}"]
            for j in range(KERNEL):
                acc = _tap(acc, full[:, j * d:j * d + b], params[f"w{l}"][j])
            h = h + torch.tanh(acc)
        # Output 1x1 conv: row-parallel, finished by one psum.
        t = x.shape[0]
        y = col.psum((h.reshape(t * b, -1) @ params["w_out"]).view(t, b),
                     mesh, axis)
        return y + params["b_out"], tuple(new_tails)

    return local_block


def shard_lstm_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                      axis: str = "tp") -> Dict[str, torch.Tensor]:
    """The calling rank's hidden units: the (H+1, 4H) gate matrix
    regrouped to (H+1, 4, H) so that each rank keeps the four gate
    columns of each of its units, then split on the unit axis."""
    hidden = params["w"].shape[1] // 4
    cols = _cols(hidden, mesh, axis)
    w4 = params["w"].reshape(hidden + 1, 4, hidden)[:, :, cols]
    return {"w": w4.contiguous(),
            "b": params["b"].reshape(4, hidden)[:, cols].contiguous(),
            "w_out": params["w_out"][cols].contiguous(),
            "b_out": params["b_out"]}


def hidden_shard(a: torch.Tensor, mesh: Mesh, axis: str = "tp"
                 ) -> torch.Tensor:
    """The calling rank's units of a (T, H) state."""
    return a[:, _cols(a.shape[1], mesh, axis)].contiguous()


def make_neuralamp_lstm_tp_block(mesh: Mesh, axis: str = "tp"):
    """Returns fn(x, h, c, params) -> (y, h', c'): x and y (T, S) whole on
    every rank, (h, c) the rank's (T, H/n) units, params from
    ``shard_lstm_params``."""

    def local_block(x, h, c, params
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        t, s = x.shape
        w4, b4 = params["w"], params["b"]
        units = w4.shape[2]
        w = w4.reshape(w4.shape[0], 4 * units)
        ys = torch.empty((s, t), dtype=torch.float32, device=x.device)
        for n in range(s):
            # The gate GEMM needs every unit of h: gather the shards.
            h_full = col.all_gather(h, mesh, axis, dim=1)
            inp = torch.cat([x[:, n:n + 1], h_full], dim=1)
            z = (inp @ w).view(t, 4, units) + b4
            i = torch.sigmoid(z[:, 0])
            f = torch.sigmoid(z[:, 1])
            g = torch.tanh(z[:, 2])
            o = torch.sigmoid(z[:, 3])
            c = f * c + i * g
            h = o * torch.tanh(c)
            ys[n] = h @ params["w_out"]  # partial: finished by the psum
        y = col.psum(ys.t().contiguous(), mesh, axis) + params["b_out"] + x
        return y, h, c

    return local_block
