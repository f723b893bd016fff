"""Programs that ``launch.spmd`` runs on every rank, each returning its
result whole (rank 0's is what ``spmd`` returns): the collectives on
meshes of the process group, one suite step, and the sharded blocks
streamed over a few blocks. On one rank they run in the calling process,
with no process group (a one-rank mesh needs none). ``device`` is "cuda"
(rank r on ``cuda:r``; the default) or "cpu", which a caller names;
inputs are whole host arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from gpuaudiobench_tpu_torch.ops import neuralamp as na
from gpuaudiobench_tpu_torch.ops.partconv import (
    num_partitions,
    partition_spectra,
)
from gpuaudiobench_tpu_torch.parallel import collectives as col
from gpuaudiobench_tpu_torch.parallel.fdtd_sharded import (
    make_fdtd_sharded_block,
)
from gpuaudiobench_tpu_torch.parallel.launch import rank_device
from gpuaudiobench_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh
from gpuaudiobench_tpu_torch.parallel.multichip import (
    OUT_DIMS,
    make_suite_step,
    shard,
    shard_args,
    suite_step_example_args,
)
from gpuaudiobench_tpu_torch.parallel.neuralamp_sharded import (
    hidden_shard,
    make_neuralamp_lstm_tp_block,
    make_neuralamp_tp_block,
    shard_lstm_params,
    shard_tcn,
)
from gpuaudiobench_tpu_torch.parallel.partconv_sharded import (
    make_partconv_sharded_block,
    partition_shard,
)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def collectives_check(shapes: Sequence[Sequence[int]], x: np.ndarray,
                      device: str = "cuda") -> List[Dict[str, np.ndarray]]:
    """For each (dp, tp, sp) mesh of the process group: ``x`` sharded over
    all three axes (one axis a dimension), then along each axis its tiled
    all_gather, psum, ring ppermute and open-chain ppermute, whole, and
    each rank's (dp, tp, sp) indices; ``"records"`` the collectives that
    communicated. Then, apart, ``"pmax <axis>"``: each axis's pmax of the
    shard, whole, and ``"pmax records"`` the pmaxes that communicated."""
    dev = rank_device(device)
    out = []
    for shape in shapes:
        mesh = make_mesh(None, *shape)
        local = shard(x, mesh, AXES, dev)
        mark = len(col.COLLECTIVES)
        res: Dict[str, np.ndarray] = {}
        for dim, axis in enumerate(AXES):
            n = mesh.axis_size(axis)
            rest = tuple(None if d == dim else a for d, a in enumerate(AXES))
            res[f"all_gather {axis}"] = _host(col.unshard(
                col.all_gather(local, mesh, axis, dim), mesh, rest))
            res[f"psum {axis}"] = _host(col.unshard(
                col.psum(local, mesh, axis), mesh, rest))
            res[f"ring {axis}"] = _host(col.unshard(
                col.ppermute(local, mesh, axis, col.ring(n)), mesh, AXES))
            chain = [(i, i + 1) for i in range(n - 1)]
            res[f"chain {axis}"] = _host(col.unshard(
                col.ppermute(local, mesh, axis, chain), mesh, AXES))
        idx = torch.tensor([[[[col.axis_index(mesh, a) for a in AXES]]]],
                           device=dev)
        res["axis_index"] = _host(col.unshard(idx, mesh, AXES + (None,)))
        res["records"] = [dict(c) for c in col.COLLECTIVES[mark:]]
        mark = len(col.COLLECTIVES)
        for dim, axis in enumerate(AXES):
            rest = tuple(None if d == dim else a for d, a in enumerate(AXES))
            res[f"pmax {axis}"] = _host(col.unshard(
                col.pmax(local, mesh, axis), mesh, rest))
        res["pmax records"] = [dict(c) for c in col.COLLECTIVES[mark:]]
        out.append(res)
    return out


def cli_runs(argvs: Sequence[List[str]], device: str = "cuda") -> List[tuple]:
    """Each CLI argument list of ``argvs`` as one rank of a multi-rank CLI
    run (``cli.rank_run``), in one launch: (exit code, rank 0's printed
    output) each. Each ``--mesh`` must have the process group's ranks."""
    from gpuaudiobench_tpu_torch import cli

    out = []
    for argv in argvs:
        cfg, names, err = cli.parse_args(argv)
        if err:
            raise ValueError(err)
        out.append(cli.rank_run(cfg, names, device))
    return out


def _shard_shapes(bench) -> Dict[str, tuple]:
    """The shapes of the device tensors that show a benchmark's shard on
    this rank: the input block, RndMemRead's playheads, the modal bank's
    amplitudes and the DWG's lengths (those it has)."""
    tensors = {"_resident_input": getattr(bench, "_resident_input", None),
               "_ph_dev": getattr(bench, "_ph_dev", None),
               "_dev.amp": getattr(bench, "_dev", {}).get("amp"),
               "_consts.0": (getattr(bench, "_consts", None) or [None])[0]}
    return {k: tuple(t.shape) for k, t in tensors.items()
            if isinstance(t, torch.Tensor)}


def dp_runs(cases: Sequence[tuple], device: str = "cuda") -> List:
    """Each (name, config fields) of ``cases`` through the runner with
    ``data_parallel`` the process group's size (one rank: this process):
    (its JSON record, every ``host_*`` array of the benchmark, whole, and
    each rank's ``_shard_shapes``), or the message of the
    ``ValueError`` its set-up raised."""
    import torch.distributed as dist

    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.output import generate_json_results
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    dev = rank_device(device)
    out = []
    for name, fields in cases:
        cfg = BenchConfig(**fields).replace(data_parallel=_world())
        try:
            bench = create_benchmark(name, cfg, dev)
            bench.setup()
        except ValueError as e:
            out.append(str(e))
            continue
        result = run_benchmark(bench, cfg, verbose=False)
        host = {k: v for k, v in vars(bench).items()
                if k.startswith("host_") and isinstance(v, np.ndarray)}
        shapes = [_shard_shapes(bench)]
        if dist.is_initialized():
            shapes = [None] * dist.get_world_size()
            dist.all_gather_object(shapes, _shard_shapes(bench))
        out.append((generate_json_results(result, cfg, dev), host, shapes))
        bench.cleanup()
    return out


def skip_collective(skipper: int) -> None:
    """Every rank but ``skipper`` joins an all-reduce: the others wait for
    it until their process group's timeout."""
    import torch.distributed as dist

    if dist.get_rank() != skipper:
        dist.all_reduce(torch.ones(4))


def suite_check(cases: Sequence[tuple], seed: int = 42,
                device: str = "cuda") -> List[tuple]:
    """For each (mesh shape, (tracks, samples, modes, ir_len)) of
    ``cases``, on a mesh of the process group: one suite step on
    ``suite_step_example_args``' inputs, (its output whole, the
    collectives the step issued)."""
    dev = rank_device(device)
    out = []
    for shape, sizes in cases:
        mesh = make_mesh(None, *shape)
        host = suite_step_example_args(tuple(shape), *sizes, seed)
        step = make_suite_step(mesh)
        args = shard_args(host, mesh, dev)
        mark = len(col.COLLECTIVES)
        y = step(*args)
        records = [dict(c) for c in col.COLLECTIVES[mark:]]
        out.append((_host(col.unshard(y, mesh, OUT_DIMS)), records))
    return out


def _to(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, copy=True)


def fdtd_blocks(x: np.ndarray, device: str = "cuda") -> np.ndarray:
    """One sharded FDTD block over a one-axis mesh ("sp") of the process
    group."""
    dev = rank_device(device)
    mesh = Mesh((_world(),), ("sp",))
    return _host(make_fdtd_sharded_block(mesh, "sp")(_to(x, dev)))


def partconv_blocks(ir: np.ndarray, xs: Sequence[np.ndarray],
                    device: str = "cuda") -> List[np.ndarray]:
    """The partition-sharded shift-form PartConv over a one-axis mesh
    ("tp") of the process group, streamed over the blocks ``xs`` from a
    silent delay line: each block's output."""
    dev = rank_device(device)
    mesh = Mesh((_world(),), ("tp",))
    t, b = xs[0].shape
    p = num_partitions(ir.shape[1], b)
    h_re, h_im = partition_spectra(_to(ir, dev), b)
    h_re, h_im = partition_shard(h_re, mesh), partition_shard(h_im, mesh)
    fdl_re = torch.zeros_like(h_re)
    fdl_im = torch.zeros_like(h_im)
    prev = torch.zeros((t, b), dtype=torch.float32, device=dev)
    fn = make_partconv_sharded_block(mesh, p)
    ys = []
    for x in xs:
        x = _to(x, dev)
        y, fdl_re, fdl_im = fn(x, prev, fdl_re, fdl_im, h_re, h_im)
        prev = x
        ys.append(_host(y))
    return ys


def tcn_blocks(params: Dict[str, np.ndarray], layers: int,
               xs: Sequence[np.ndarray], device: str = "cuda"):
    """The channel-sharded f32 TCN over a one-axis mesh ("tp") of the
    process group, streamed over ``xs`` from zero tails: (each block's
    output, the last tails whole)."""
    dev = rank_device(device)
    mesh = Mesh((_world(),), ("tp",))
    t, c = xs[0].shape[0], params["w_in"].shape[0]
    cp = na.cast_params(params, "f32", dev)
    tails = na.init_tails(t, c, layers, "f32", dev)
    local, tails = shard_tcn(cp, tails, layers, mesh)
    fn = make_neuralamp_tp_block(mesh, layers)
    ys = []
    for x in xs:
        y, tails = fn(_to(x, dev), tails, local)
        ys.append(_host(y))
    return ys, [_host(col.unshard(tl, mesh, (None, None, "tp")))
                for tl in tails]


def lstm_blocks(params: Dict[str, np.ndarray], xs: Sequence[np.ndarray],
                device: str = "cuda"):
    """The hidden-sharded f32 LSTM over a one-axis mesh ("tp") of the
    process group, streamed over ``xs`` from a zero state: (each block's
    output, the last h and c whole)."""
    dev = rank_device(device)
    mesh = Mesh((_world(),), ("tp",))
    t, hidden = xs[0].shape[0], params["w_out"].shape[0]
    local = shard_lstm_params(na.cast_lstm_params(params, "f32", dev), mesh)
    zero = torch.zeros((t, hidden), dtype=torch.float32, device=dev)
    h, c = hidden_shard(zero, mesh), hidden_shard(zero, mesh)
    fn = make_neuralamp_lstm_tp_block(mesh)
    ys = []
    for x in xs:
        y, h, c = fn(_to(x, dev), h, c, local)
        ys.append(_host(y))
    whole = (None, "tp")
    return ys, _host(col.unshard(h, mesh, whole)), _host(
        col.unshard(c, mesh, whole))


BLOCKS = {"fdtd": fdtd_blocks, "partconv": partconv_blocks,
          "tcn": tcn_blocks, "lstm": lstm_blocks}


def blocks_check(cases: Sequence[tuple], device: str = "cuda") -> list:
    """Each (kind, args) of ``cases`` through ``BLOCKS[kind](*args)`` on
    the process group, in one launch."""
    return [BLOCKS[kind](*args, device=device) for kind, args in cases]


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def json_runs(cases: Sequence[tuple], device: str = "cuda") -> List[dict]:
    """Each (benchmark name, config) of ``cases`` through
    ``cli.rank_json`` on the process group, in one launch: each one's
    JSON record (the benchmarks read the mesh from their config)."""
    from gpuaudiobench_tpu_torch import cli

    return [cli.rank_json(name, cfg, device) for name, cfg in cases]
