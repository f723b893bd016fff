"""A device mesh of ranks: the counterpart of ``jax.sharding.Mesh``.

PyTorch counterpart of ``gpuaudiobench_tpu/parallel/mesh.py`` and of the
mesh helpers of ``gpuaudiobench_tpu/models/multichip_bench.py``. Three
axes, as there:

* "dp": data parallel, the track axis;
* "tp": tensor parallel, the modal bank's mode axis (and the cascade's
  pipeline stages);
* "sp": sequence parallel, the sample axis of the convolution.

A mesh of n ranks lays its ranks out as ``np.arange(n).reshape(shape)``,
the layout the JAX mesh gives its devices, so rank r holds the shard the
JAX program gives device r. Each axis has one process group per line
(the ranks that differ only along it). Every rank creates every line's
group, in the same order, including the lines it is not on:
``torch.distributed.new_group`` is collective over the whole world, and
a rank that skipped one would leave the others waiting. A one-member
axis has no group (its collectives communicate nothing), so a mesh of
one rank needs no process group at all.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "tp", "sp")
# The devices a CPU mesh may span: the JAX tests' virtual CPU devices
# (tests/conftest.py); each is a gloo rank here.
CPU_DEVICES = 8


def _factor3(n: int) -> Tuple[int, int, int]:
    """Split n devices into (dp, tp, sp) factors, largest first on dp."""
    best = (n, 1, 1)
    for sp in (1, 2, 4, 8):
        for tp in (1, 2, 4, 8):
            if n % (sp * tp) == 0:
                dp = n // (sp * tp)
                cand = (dp, tp, sp)
                # prefer balanced meshes
                if max(cand) - min(cand) < max(best) - min(best):
                    best = cand
    return best


def parse_mesh(spec: str):
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) != 3 or not all(p.isdigit() and int(p) >= 1 for p in parts):
        raise ValueError(
            f"--mesh expects 'dp,tp,sp' positive integers, got {spec!r}"
        )
    return tuple(int(p) for p in parts)


def available_devices(device: torch.device) -> int:
    """The ranks a mesh on ``device``'s type may have: the CUDA device
    count, or ``CPU_DEVICES`` on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return CPU_DEVICES


class Mesh:
    """The mesh of the calling rank: ``shape`` ({axis: size}), this rank's
    coordinates, and a process group for each of its lines."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not name "
                             f"axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = int(np.prod(list(self.shape.values())))
        if self.size == 1:
            self.rank = 0
        else:
            if not dist.is_initialized() or dist.get_world_size() != self.size:
                world = dist.get_world_size() if dist.is_initialized() else 1
                raise ValueError(
                    f"a mesh of {self.size} ranks needs a process group of "
                    f"{self.size} ({world} here): run it through the CLI or "
                    "parallel.launch.spmd")
            self.rank = dist.get_rank()
        ids = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = self.coords_of(self.rank)
        self._lines: Dict[str, List[int]] = {}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for k, axis in enumerate(self.axis_names):
            moved = np.moveaxis(ids, k, -1).reshape(-1, self.shape[axis])
            for line in moved.tolist():
                group = dist.new_group(line) if len(line) > 1 else None
                if self.rank in line:
                    self._lines[axis] = line
                    self._groups[axis] = group

    def coords_of(self, rank: int) -> Dict[str, int]:
        """{axis: index} of ``rank`` in the layout ``arange(n).reshape``."""
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def line(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, by axis
        index."""
        return self._lines[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's line along ``axis`` (None on a
        one-member axis)."""
        return self._groups[axis]


def check_devices(shape: Sequence[int], device: torch.device,
                  flag: str = "--mesh") -> None:
    """Raises the JAX package's message for a mesh of more ranks than
    ``available_devices``, naming the ``flag`` that asked for it."""
    n = int(np.prod(shape))
    have = available_devices(device)
    if have < n:
        raise ValueError(
            f"{flag} {'x'.join(map(str, shape))} needs {n} devices; "
            f"{have} available"
        )


def build_mesh(shape: Sequence[int], axis_names: Sequence[str],
               device: torch.device, flag: str = "--mesh") -> Mesh:
    """The calling rank's mesh on ``device``'s type (``check_devices``
    first)."""
    check_devices(shape, device, flag)
    return Mesh(shape, axis_names)


def dp_mesh(n: int, device: torch.device) -> Mesh:
    """The one-axis ("dp",) mesh of ``--dataParallel n``: every rank of
    the process group, each holding one shard. More ranks than devices
    raise, where the JAX package's ``dp_sharding`` takes
    ``jax.devices()[:n]`` and builds a smaller mesh."""
    return build_mesh((n,), ("dp",), device, "--dataParallel")


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """A (dp, tp, sp) mesh over the process group (or of ``n_devices``
    ranks); missing factors come from ``_factor3``."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if dp is None or tp is None or sp is None:
        dp, tp, sp = _factor3(n)
    if dp * tp * sp != n:
        raise ValueError(f"mesh {dp}x{tp}x{sp} != {n} devices")
    return Mesh((dp, tp, sp), AXES)


__all__ = ["AXES", "CPU_DEVICES", "Mesh", "_factor3", "available_devices",
           "build_mesh", "check_devices", "dp_mesh", "make_mesh",
           "parse_mesh"]
