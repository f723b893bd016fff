"""The collectives of the JAX package's SPMD programs, on a ``Mesh``.

Counterparts of ``jax.lax.all_gather(..., tiled=True)``, ``psum``,
``pmax``, ``ppermute`` and ``axis_index`` inside ``shard_map``, with their
semantics, over ``torch.distributed`` on the axis's process group (NCCL
on CUDA devices, gloo on the CPU):

* ``all_gather(x, mesh, axis, dim)``: the axis's shards of ``x``
  concatenated along ``dim`` in axis order.
* ``psum(x, mesh, axis)``: the sum over the axis, on every member.
* ``pmax(x, mesh, axis)``: the elementwise max over the axis, on every
  member (exact, so every member holds the same bits).
* ``ppermute(x, mesh, axis, perm)``: ``perm`` pairs (source, destination)
  of axis indices; a member that is no pair's destination gets zeros (an
  open chain's first member does). It runs as one
  ``batch_isend_irecv`` on the axis's group, its group ranks translated
  to global ones.

On a one-member axis each returns its input and communicates nothing.
Every collective that communicates is counted in ``COLLECTIVES``, one
record a call (the counterpart of the kernels' ``KERNEL_LAUNCHES``):
its kind, axis, axis size and bytes, where the bytes are those of the
whole gathered output (all_gather), of the reduced tensor (psum, pmax), or
shipped by each member (ppermute), as the JAX package's collective
inventory counts them (``parallel/ici_model.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from gpuaudiobench_tpu_torch.parallel.mesh import Mesh

COLLECTIVES: List[Dict] = []


def _record(kind: str, axis: str, axis_n: int, t: torch.Tensor) -> None:
    COLLECTIVES.append({"kind": kind, "axis": axis, "axis_n": axis_n,
                        "bytes": t.numel() * t.element_size()})


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.axis_index(axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    out = torch.cat(parts, dim=dim)
    _record("all_gather", axis, n, out)
    return out


def _all_reduce(kind: str, op, x: torch.Tensor, mesh: Mesh,
                axis: str) -> torch.Tensor:
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.group(axis))
    _record(kind, axis, n, out)
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _all_reduce("psum", dist.ReduceOp.SUM, x, mesh, axis)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _all_reduce("pmax", dist.ReduceOp.MAX, x, mesh, axis)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    me, line, group = mesh.axis_index(axis), mesh.line(axis), mesh.group(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, line[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, line[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _record("ppermute", axis, n, x)
    return out


def ring(n: int) -> List[Tuple[int, int]]:
    """The ring shift i -> i + 1 (mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]




def unshard(local: torch.Tensor, mesh: Mesh,
            dims: Sequence[object]) -> torch.Tensor:
    """The global tensor of a sharded result, on every rank: the
    counterpart of reading a sharded ``jax.Array`` back whole, and no
    part of a program, so not counted in ``COLLECTIVES``. ``dims`` names
    the mesh axis that shards each dimension of ``local`` (None: not
    sharded; every rank holds the same values there)."""
    if mesh.size == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local)
    shape = [s * (mesh.axis_size(a) if a else 1)
             for s, a in zip(local.shape, dims)]
    out = local.new_empty(shape)
    for r, part in enumerate(parts):
        coords = mesh.coords_of(r)
        index = tuple(
            slice(coords[a] * s, (coords[a] + 1) * s) if a else slice(None)
            for s, a in zip(local.shape, dims))
        out[index] = part
    return out


__all__ = ["COLLECTIVES", "all_gather", "axis_index", "pmax", "ppermute",
           "psum", "ring", "unshard"]
