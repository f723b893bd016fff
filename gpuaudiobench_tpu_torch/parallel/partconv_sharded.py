"""Partition-sharded streaming convolution: the reverb tail over a mesh
axis.

PyTorch counterpart of ``gpuaudiobench_tpu/parallel/partconv_sharded.py``.
The partition axis of the shift-form delay line (FDL) and of the IR
spectra H is sharded: each rank owns P/n consecutive partitions of both,
so per block

* every rank computes the forward spectrum of the (whole) input block,
  with no communication;
* the delay line's one-slot shift becomes one spectrum handoff between
  neighbours (a ppermute on the open chain i -> i+1: the spectrum
  leaving rank r's last slot enters rank r+1's first; rank 0 takes the
  fresh spectrum, and the last rank's oldest falls off the IR's end);
* each rank multiply-accumulates its partial Y over its partitions, and
  one psum of each plane gives the whole spectrum, inverse-transformed
  on every rank.

Only the shift form shards: the ring form's rotating head would make
slot ownership depend on the block. Plain torch, as the original is
plain XLA and the single-device block (``ops/partconv.py``) is.
"""

from __future__ import annotations

import torch

from gpuaudiobench_tpu_torch.ops.partconv import (
    _forward_spectrum,
    _inverse_block,
    _mac,
)
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel.mesh import Mesh


def make_partconv_sharded_block(mesh: Mesh, partitions: int,
                                axis: str = "tp"):
    """Returns fn(x, prev, fdl_re, fdl_im, h_re, h_im) -> (y, fdl_re',
    fdl_im'): x, prev and y (T, B) whole on every rank; fdl and h the
    rank's (T, P/n, B+1) shards of ``partition_spectra``'s layout
    (``partition_shard``)."""
    nshards = mesh.axis_size(axis)
    if partitions % nshards != 0:
        raise ValueError(
            f"partitions ({partitions}) not divisible by mesh axis "
            f"{axis!r} ({nshards})")
    fwd_perm = [(i, i + 1) for i in range(nshards - 1)]
    first = mesh.axis_index(axis) == 0

    def local_block(x, prev, fdl_re, fdl_im, h_re, h_im):
        b = x.shape[1]
        sre, sim = _forward_spectrum(x, prev)
        # The spectrum entering this rank's first slot: the previous
        # rank's last slot or, on rank 0, the fresh spectrum.
        in_re = col.ppermute(fdl_re[:, -1], mesh, axis, fwd_perm)
        in_im = col.ppermute(fdl_im[:, -1], mesh, axis, fwd_perm)
        if first:
            in_re, in_im = sre, sim
        fdl_re = torch.cat([in_re[:, None], fdl_re[:, :-1]], dim=1)
        fdl_im = torch.cat([in_im[:, None], fdl_im[:, :-1]], dim=1)
        y_re, y_im = _mac(fdl_re, fdl_im, h_re, h_im)
        y_re = col.psum(y_re, mesh, axis)
        y_im = col.psum(y_im, mesh, axis)
        return _inverse_block(y_re, y_im, b), fdl_re, fdl_im

    return local_block


def partition_shard(a: torch.Tensor, mesh: Mesh, axis: str = "tp"
                    ) -> torch.Tensor:
    """The calling rank's partitions of a (T, P, B+1) plane."""
    n = a.shape[1] // mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    return a[:, i * n:(i + 1) * n].contiguous()
