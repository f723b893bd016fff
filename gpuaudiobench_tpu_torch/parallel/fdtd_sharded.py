"""Spatially sharded 3-D FDTD: the room's x axis over a mesh axis.

PyTorch counterpart of ``gpuaudiobench_tpu/parallel/fdtd_sharded.py``.
Each rank holds rows [i*R, (i+1)*R) of the pressure grid and exchanges
one pressure plane with each neighbour every substep (a ppermute halo
each way): the stencil's domain decomposition, the scaling path for
rooms larger than one device's memory.

Face ownership: rank i holds pressure rows [i*R, (i+1)*R) and velocity
faces [i*R, (i+1)*R] inclusive: the boundary faces are computed on both
neighbours from the exchanged halos, so the divergence needs no second
exchange. The receiver's pressure comes back through a psum (only its
owner adds a nonzero value). It is plain torch, as the original is
plain XLA; the field form's single-device kernel
(``ops/fdtd3d.py:fdtd3d_block_field``) is what it is held against.
"""

from __future__ import annotations

import torch

from gpuaudiobench_tpu_torch.ops import fdtd3d as C
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel.mesh import Mesh


def make_fdtd_sharded_block(mesh: Mesh, axis: str = "sp",
                            steps_per_sample: int = C.STEPS_PER_SAMPLE):
    """Returns fn(x (tracks, S)) -> out (tracks, S), the whole FDTD block
    with the room's x axis sharded over ``axis``; x and out whole on
    every rank. Fields start at rest every block (benchmark semantics)."""
    nshards = mesh.axis_size(axis)
    n = C.GRID_N
    if n % nshards != 0:
        raise ValueError(f"grid {n} not divisible by {nshards} shards")
    rows = n // nshards
    sx, sy, sz = C.SOURCE
    rx, ry, rz = C.RECEIVER
    fwd_perm = col.ring(nshards)
    bwd_perm = [(i, (i - 1) % nshards) for i in range(nshards)]

    def local_block(x: torch.Tensor) -> torch.Tensor:
        tracks, s = x.shape
        dev = x.device
        r0 = mesh.axis_index(axis) * rows

        gx = (r0 + torch.arange(rows, device=dev))[:, None, None]
        gy = torch.arange(n, device=dev)[None, :, None]
        gz = torch.arange(n, device=dev)[None, None, :]
        boundary = ((gx == 0) | (gx == n - 1) | (gy == 0) | (gy == n - 1)
                    | (gz == 0) | (gz == n - 1))
        # faces this shard computes: global face index in [1, n-1]
        gfx = (r0 + torch.arange(rows + 1, device=dev))[:, None, None]
        fmask = ((gfx >= 1) & (gfx <= n - 1)).float()
        src_mask = ((gx == sx) & (gy == sy) & (gz == sz)).float()
        rcv_mask = ((gx == rx) & (gy == ry) & (gz == rz)).float()

        f32 = dict(dtype=torch.float32, device=dev)
        p = torch.zeros((rows, n, n), **f32)
        vx = torch.zeros((rows + 1, n, n), **f32)
        vy = torch.zeros((rows, n + 1, n), **f32)
        vz = torch.zeros((rows, n, n + 1), **f32)
        src = C.source_row(x)
        rcv = torch.empty(s, **f32)
        for smp in range(s):
            p = p + src_mask * src[smp]
            for _ in range(steps_per_sample):
                # one-plane halo exchange each way (the edge wrap is masked)
                left = col.ppermute(p[-1:], mesh, axis, fwd_perm)
                right = col.ppermute(p[:1], mesh, axis, bwd_perm)
                p_ext = torch.cat([left, p, right], dim=0)  # (rows+2, n, n)
                vx = vx - C.K1 * fmask * (p_ext[1:] - p_ext[:-1])
                vy = vy.clone()
                vy[:, 1:n, :] += -C.K1 * (p[:, 1:, :] - p[:, :-1, :])
                vz = vz.clone()
                vz[:, :, 1:n] += -C.K1 * (p[:, :, 1:] - p[:, :, :-1])
                div = ((vx[1:] - vx[:-1]) + (vy[:, 1:, :] - vy[:, :-1, :])
                       + (vz[:, :, 1:] - vz[:, :, :-1]))
                p = torch.where(boundary, p * C.ABSORB, p - C.K2 * div)
            rcv[smp] = torch.sum(rcv_mask * p)  # nonzero on the owner only
        rcv = col.psum(rcv, mesh, axis) * C.F_OUTPUT_SCALE  # (S,)
        return rcv[None, :].expand(tracks, s).contiguous()

    return local_block
