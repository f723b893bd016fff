"""FDTD3D in the PyTorch port (both block forms' plain twins, the
geometry, the golden and the benchmark) against the JAX package, on the
CPU at rooms 8 and 14.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode, as tests/test_pallas_ops.py runs
them; fields are chained over 2 blocks, so the second starts from a
ringing room. Tolerances, absolute:

* the field twin against the JAX ``fdtd3d_block`` and
  ``fdtd3d_block_pallas``, and with per-track receivers against
  ``fdtd3d_block_multircv``: 1e-6 (the same float32 updates; the
  reference's bar, tests/test_pallas_ops.py:33), receivers off the grid
  among them (read as XLA's gather reads them: a negative cell wrapped
  once, then clamped);
* the divergence twin against ``fdtd3d_block_pallas_div`` (div' too) and
  against the field twin: 1e-5 (the divergence form reassociates the
  update; the reference's bar, tests/test_benchmarks.py:189);
* benchmark outputs, port vs JAX: 1e-5; goldens bit for bit.

The CUDA kernels' route (``fdtd_schedule``, ``plane_schedule``) is
checked here as host code, and NumPy emulations of the kernels' layouts
match the twins bit for bit: the divergence form's cluster layout (each
block's range with its halos, the edge cells handed to the neighbours)
and its plane layout (a block a plane, the planes handed on through a
two-parity exchange, the blocks run in a random order that the flags
allow), and the field form's plane layout (the same exchange, each block
with a replica of the vx faces above its plane, the receivers bucketed by
plane); the kernels themselves run in ``tests/test_torch_cuda.py``.
"""

import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.models.fdtd3d import fdtd3d_reference as jax_reference
from gpuaudiobench_tpu.ops import fdtd3d as jop
from gpuaudiobench_tpu.ops.fdtd3d_pallas import (
    fdtd3d_block_pallas,
    fdtd3d_block_pallas_div,
)
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.models.fdtd3d import fdtd3d_reference
from gpuaudiobench_tpu_torch.ops import fdtd3d as op
from gpuaudiobench_tpu_torch.registry import create_benchmark

CPU = torch.device("cpu")
FIELD_ATOL = 1e-6
DIV_ATOL = 1e-5
CASES = [(8, 16), (14, 8)]  # (room, samples)
TRACKS = 3


def _geometry(room):
    n = op.grid_n(room)
    return n, op.source_pos(room), op.receiver_pos(room)


def _x(rng, s, tracks=TRACKS):
    return (rng.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _div_of(vx, vy, vz):
    """div v on the interior, zero elsewhere: the divergence form's state
    for a field-form state."""
    vx, vy, vz = (np.asarray(v) for v in (vx, vy, vz))
    d = ((vx[1:] - vx[:-1]) + (vy[:, 1:] - vy[:, :-1])
         + (vz[:, :, 1:] - vz[:, :, :-1]))
    out = np.zeros_like(d)
    out[1:-1, 1:-1, 1:-1] = d[1:-1, 1:-1, 1:-1]
    return out


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("room,s", CASES)
def test_field_twin_matches_jax_xla_and_pallas(rng, room, s):
    n, src, rcv = _geometry(room)
    x = _x(rng, s)
    ours = tuple(op.zero_fields(n))
    xla = tuple(np.asarray(f) for f in op.zero_fields(n))
    pallas = xla
    for _ in range(2):
        out, *ours = op.fdtd3d_block_field_plain(_t(x), *ours, src, rcv)
        ref, *xla = jop.fdtd3d_block(x, *xla, source=src, receiver=rcv)
        with pltpu.force_tpu_interpret_mode():
            pk, *pallas = fdtd3d_block_pallas(x, *pallas, source=src,
                                              receiver=rcv)
        _close(out, ref, FIELD_ATOL)
        _close(out, pk, FIELD_ATOL)
        for a, b, c in zip(ours, xla, pallas):
            _close(a, b, FIELD_ATOL)
            _close(a, c, FIELD_ATOL)
    assert np.abs(out.numpy()).max() > 1e-4  # the receiver hears the source


@pytest.mark.parametrize("room,s", CASES)
def test_div_twin_matches_jax_pallas_div(rng, room, s):
    n, src, rcv = _geometry(room)
    x = _x(rng, s)
    ours = op.zero_fields_div(n)
    theirs = tuple(np.asarray(f) for f in ours)
    for _ in range(2):
        out, *ours = op.fdtd3d_block_div_plain(_t(x), *ours, src, rcv)
        with pltpu.force_tpu_interpret_mode():
            ref, *theirs = fdtd3d_block_pallas_div(x, *theirs, source=src,
                                                   receiver=rcv)
        _close(out, ref, DIV_ATOL)
        _close(ours[0], theirs[0], DIV_ATOL)
        _close(ours[1], theirs[1], DIV_ATOL)
    d = ours[1].numpy()
    inner = np.zeros_like(d, bool)
    inner[1:-1, 1:-1, 1:-1] = True
    assert not d[~inner].any() and d[inner].any()


@pytest.mark.parametrize("room,s", CASES)
def test_div_twin_matches_field_twin(rng, room, s):
    n, src, rcv = _geometry(room)
    x = _x(rng, s)
    field = op.zero_fields(n)
    div = op.zero_fields_div(n)
    for _ in range(2):
        out_f, *field = op.fdtd3d_block_field_plain(_t(x), *field, src, rcv)
        out_d, *div = op.fdtd3d_block_div_plain(_t(x), *div, src, rcv)
        _close(out_d, out_f, DIV_ATOL)
        _close(div[0], field[0], DIV_ATOL)
        _close(div[1], _div_of(*field[1:]), DIV_ATOL)


@pytest.mark.parametrize("room,s", CASES)
def test_per_track_receivers_match_jax_multircv(rng, room, s):
    n, src, rcv = _geometry(room)
    tracks = 6
    x = _x(rng, s, tracks)
    xs, ys, zs = op.receiver_line(tracks, n)
    flat = ((xs.astype(np.int64) * n + ys) * n + zs).astype(np.int32)
    ours = op.zero_fields(n)
    theirs = tuple(np.asarray(f) for f in ours)
    for _ in range(2):
        out, *ours = op.fdtd3d_block_field_plain(_t(x), *ours, src, rcv,
                                                 receivers=_t(flat))
        ref, *theirs = jop.fdtd3d_block_multircv(x, *theirs, flat, source=src)
        assert out.shape == (tracks, s)
        _close(out, ref, FIELD_ATOL)
        for a, b in zip(ours, theirs):
            _close(a, b, FIELD_ATOL)
    assert len(set(out[:, -1].tolist())) > 1  # the tracks differ


# Receivers off the grid: the two sets given at room 8 (n^3 = 1,000) and
# one built from n^3 (past the end, -1, wrapped and still negative, the
# last cell).
OFF_GRID = {"a": lambda n3: [503, -1, 7, 100],
            "b": lambda n3: [0, 1040, -1009, 12],
            "edges": lambda n3: [n3 + 40, -1, -n3 - 9, n3 - 1]}


@pytest.mark.parametrize("cells", sorted(OFF_GRID))
@pytest.mark.parametrize("room,s", CASES)
def test_off_grid_receivers_read_as_jax_multircv(rng, room, s, cells):
    """No receiver value raises: ``fdtd3d_block_field`` (its CPU twin
    here) reads each cell as the JAX ``fdtd3d_block_multircv`` gathers it,
    over 2 blocks, within FIELD_ATOL."""
    n, src, rcv = _geometry(room)
    flat = np.array(OFF_GRID[cells](n ** 3), np.int32)
    x = _x(rng, s, flat.size)
    ours = op.zero_fields(n)
    theirs = tuple(np.asarray(f) for f in ours)
    for _ in range(2):
        out, *ours = op.fdtd3d_block_field(_t(x), *ours, src, rcv,
                                           receivers=_t(flat))
        ref, *theirs = jop.fdtd3d_block_multircv(x, *theirs, flat, source=src)
        _close(out, ref, FIELD_ATOL)
        for a, b in zip(ours, theirs):
            _close(a, b, FIELD_ATOL)


@pytest.mark.parametrize("room", [8, 14, 128])
def test_normalized_receivers_are_jax_gathers(room):
    """``normalize_receivers`` is the cell ``jnp`` indexing reads: a
    negative index wrapped once, then clamped to the array."""
    import jax.numpy as jnp

    n3 = op.grid_n(room) ** 3
    raw = np.array([0, 1, n3 - 1, n3, n3 + 7, 10 * n3, -1, -n3, -n3 - 1,
                    -5 * n3, 2 ** 31 - 1, -2 ** 31], np.int64).astype(
                        np.int32)
    want = np.asarray(jnp.arange(n3, dtype=jnp.int32)[jnp.asarray(raw)])
    got = op.normalize_receivers(_t(raw), op.grid_n(room))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_receiver_buckets_wrapper_on_cpu_is_the_twin():
    n = op.grid_n(8)
    rcv = _t(np.array([503, -1, 7, 100, 0, 1040, -1009, 12], np.int32))
    launches = dict(op.KERNEL_LAUNCHES)
    cells, order, starts = op.receiver_buckets(rcv, n)
    assert op.KERNEL_LAUNCHES == launches
    for g, w in zip((cells, order, starts),
                    op.receiver_buckets_plain(rcv, n)):
        assert torch.equal(g, w)
    assert cells.tolist() == [503, 999, 7, 100, 0, 999, 0, 12]
    ref_order, ref_starts = op.receiver_csr(cells.numpy(), n)
    assert order.tolist() == ref_order.tolist()
    assert starts.tolist() == ref_starts
    for bad in (rcv.to(torch.int64), rcv[None], rcv[::2], rcv[:0]):
        with pytest.raises(ValueError, match="contiguous int32"):
            op.receiver_buckets(bad, n)
    with pytest.raises(ValueError, match="no bucketing kernel"):
        op.receiver_buckets(rcv, op.FIELD_MAX_PLANES + 1)


@pytest.mark.parametrize("room", [8, 14, 50, 128])
def test_geometry_and_constants_are_the_reference(room):
    assert op.grid_n(room) == jop.grid_n(room)
    assert op.source_pos(room) == jop.source_pos(room)
    assert op.receiver_pos(room) == jop.receiver_pos(room)
    for a, b in zip(op.receiver_line(7, op.grid_n(room)),
                    jop.receiver_line(7, jop.grid_n(room))):
        assert np.array_equal(a, b)
    for k in ("SOURCE", "RECEIVER", "GRID_N", "STEPS_PER_SAMPLE",
              "TIME_STEP", "DT_OVER_RHO_DX", "RHO_C2_DT_OVER_DX",
              "SOURCE_SCALE", "OUTPUT_SCALE", "ABSORPTION"):
        assert getattr(op, k) == getattr(jop, k), k
    assert op.C6 == np.float32(6.0) * np.float32(jop.DT_OVER_RHO_DX)


@pytest.mark.parametrize("per_track", [False, True])
def test_golden_is_the_reference_golden(rng, per_track):
    n, src, rcv = _geometry(8)
    x = _x(rng, 12, 4)
    rcvs = op.receiver_line(4, n) if per_track else None
    assert np.array_equal(
        fdtd3d_reference(x, receivers=rcvs, n=n, source=src, receiver=rcv),
        jax_reference(x, receivers=rcvs, n=n, source=src, receiver=rcv))


def test_wrappers_on_cpu_are_the_twins(rng):
    n, src, rcv = _geometry(8)
    x = _t(_x(rng, 8))
    launches = dict(op.KERNEL_LAUNCHES)
    fields = op.zero_fields(n)
    fields[0][3, 4, 5] = 0.25
    got = op.fdtd3d_block_field(x, *fields, src, rcv)
    want = op.fdtd3d_block_field_plain(x, *fields, src, rcv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fields[0][3, 4, 5] == 0.25 and fields[0].sum() == 0.25
    got = op.fdtd3d_block_div(x, *op.zero_fields_div(n), src, rcv)
    want = op.fdtd3d_block_div_plain(x, *op.zero_fields_div(n), src, rcv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert op.KERNEL_LAUNCHES == launches


def test_wrappers_reject_bad_input(rng):
    n, src, rcv = _geometry(8)
    x = _t(_x(rng, 8))
    p, vx, vy, vz = op.zero_fields(n)
    with pytest.raises(ValueError, match="vx must be"):
        op.fdtd3d_block_field(x, p, vy, vy, vz, src, rcv)
    with pytest.raises(TypeError, match="float32"):
        op.fdtd3d_block_div(x, p.double(), p, src, rcv)
    with pytest.raises(ValueError, match="outside"):
        op.fdtd3d_block_div(x, p, p, source=(n, 1, 1))
    with pytest.raises(ValueError, match="receivers must be int32"):
        op.fdtd3d_block_field(x, p, vx, vy, vz, src, rcv,
                              receivers=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no interior"):
        op.fdtd3d_block_div(x, *op.zero_fields_div(2), (0, 0, 0), (1, 1, 1))
    meta = [torch.empty(f.shape, device="meta") for f in (x, p, p)]
    with pytest.raises(ValueError, match="no kernel"):
        op.fdtd3d_block_div(*meta, src, rcv)


# -- the benchmark, end to end against the JAX package -------------------

@pytest.fixture
def jax_cfg(small_cfg):
    return small_cfg.replace(impl="xla", n_tracks=4, buffer_size=12,
                             fdtd_room=8)


def _port(cfg):
    return BenchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _pair(cfg):
    jb = jax_create("FDTD3D", cfg)
    jb.setup()
    pb = create_benchmark("FDTD3D", _port(cfg), CPU)
    pb.setup()
    return jb, pb


@pytest.mark.parametrize("per_track", [False, True])
def test_benchmark_matches_jax(jax_cfg, per_track):
    cfg = jax_cfg.replace(fdtd_per_track_receivers=per_track)
    jb, pb = _pair(cfg)
    assert np.array_equal(pb.host_input, jb.host_input)
    assert np.array_equal(pb.golden, jb.golden)
    _close(pb.host_output, jb.host_output, DIV_ATOL)
    for _ in range(2):
        jb.iterate()
        pb.iterate()
    _close(pb.host_output, jb.host_output, DIV_ATOL)
    v = pb.validate()
    assert v.passed and v.max_error < 1e-5, v.messages[:3]
    assert pb.metadata() == {**jb.metadata(), "impl": "torch-plain"}


@pytest.mark.parametrize("per_track", [False, True])
def test_stream_resumes_from_jax_fields(jax_cfg, per_track):
    """Both streams from rest for 2 blocks (the JAX package's XLA stream
    carries the field form); then the port's stream takes the JAX fields,
    as (p, div) in the divergence form, and its next block matches."""
    cfg = jax_cfg.replace(fdtd_per_track_receivers=per_track)
    jb, pb = _pair(cfg)
    jstep, jcarry = jb.stream_body()
    pstep, pcarry = pb.stream_body()
    for _ in range(2):
        jcarry, jprobe = jstep(jcarry)
        pcarry, pprobe = pstep(pcarry)
        assert pprobe.item() == pytest.approx(float(np.asarray(jprobe)[0]),
                                              abs=DIV_ATOL)
    p, vx, vy, vz = (np.asarray(f) for f in jcarry[1])
    fields = (p, vx, vy, vz) if per_track else (p, _div_of(vx, vy, vz))
    resumed = create_benchmark("FDTD3D", _port(cfg), CPU)
    resumed.load_data(jb.host_input, stream_fields=fields)
    rstep, rcarry = resumed.stream_body()
    _, rprobe = rstep(rcarry)
    _, jprobe = jstep(jcarry)
    _, pprobe = pstep(pcarry)
    assert rprobe.item() == pytest.approx(float(np.asarray(jprobe)[0]),
                                          abs=DIV_ATOL)
    assert rprobe.item() == pytest.approx(pprobe.item(), abs=DIV_ATOL)


def test_corrupted_output_fails_validation(jax_cfg):
    _, pb = _pair(jax_cfg)
    pb.host_output = pb.host_output.copy()
    pb.host_output[1, 5] += 0.01
    assert not pb.validate().passed


@pytest.mark.parametrize("per_track", [False, True])
def test_benchmark_runs_through_the_runner(jax_cfg, per_track):
    cfg = _port(jax_cfg).replace(n_runs=2, warmup=1, pipeline_depth=4,
                                 saturated_reps=2, device_timing=True,
                                 fdtd_per_track_receivers=per_track)
    b = create_benchmark("FDTD3D", cfg, CPU)
    b.setup()
    res = run_benchmark(b, cfg, verbose=False)
    assert res.validation.passed, res.validation.messages[:3]
    assert len(res.saturated_latencies) == 2
    assert res.device_timing_method == "wall"


def test_load_data_rejects_wrong_stream_fields(jax_cfg):
    pb = create_benchmark("FDTD3D", _port(jax_cfg), CPU)
    x = np.zeros((4, 12), np.float32)
    with pytest.raises(ValueError, match="stream fields"):
        pb.load_data(x, stream_fields=[np.zeros((10, 10, 10), np.float32)])
    with pytest.raises(ValueError, match="input"):
        pb.load_data(x[:2])


@pytest.mark.parametrize("argv,want", [
    (["--fdtdRoom", "10"], {"room": 10, "grid": [12, 12, 12],
                            "receiver": [9, 4, 6]}),
    (["--fdtdRoom", "8", "--fdtdPerTrackReceivers"],
     {"room": 8, "receiver": "per-track line"}),
])
def test_fdtd_flags_reach_the_benchmark(argv, want):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--benchmark", "FDTD3D", "--nTracks", "3",
                       "--bufferSize", "8", "--nRuns", "2", "--warmup", "1",
                       "--json"] + argv, device="cpu")
    lines = buf.getvalue().splitlines()
    assert rc == 0, lines[-20:]
    rec = json.loads("\n".join(lines[lines.index("{"):-1]))
    assert rec["validation"]["status"] == "SUCCESS"
    for k, v in want.items():
        assert rec["metadata"][k] == v


# -- the route of the CUDA kernels (ops.fdtd3d.fdtd_schedule) ------------

SMEM_PER_BLOCK = 232_448  # the opt-in shared memory of a block on sm_90


@settings(max_examples=200, deadline=None)
@given(n=st.integers(10, 130), form=st.sampled_from(["div", "field"]))
def test_schedule_covers_the_grid_and_fits(n, form):
    plan = op.fdtd_schedule(n, form)
    if form == "field":  # the plane route at every room
        cpt = -(-n * n // 1024) | 1
        bufs = 2 if cpt <= 7 else 3  # two p; one p, vy and vz
        assert plan == op.plane_schedule(n, "field")
        _check_plane_plan(n, plan, bufs)
        return
    blocks = 16 if n >= 16 else 8
    nn, cells = n * n, n ** 3
    cap = -(-cells // blocks)
    fits = (op.cluster_smem_bytes(n, cap) <= SMEM_PER_BLOCK
            and cap <= 19 * 1024)
    assert (plan.route == "cluster") == fits
    if plan.route != "cluster":  # the plane route
        assert plan == op.plane_schedule(n)
        _check_plane_plan(n, plan)
        return
    assert plan.blocks == blocks == len(plan.ranges)
    # two p buffers of the longest range with an n^2 halo each side, 8
    # floats ahead, and at most one iteration of 1,024 threads (and 15) of
    # padding a buffer
    assert plan.smem_bytes == op.cluster_smem_bytes(n, cap) <= SMEM_PER_BLOCK
    layout = 4 * (8 + 2 * (cap + 2 * nn))
    assert layout + 8 * 1036 <= plan.smem_bytes <= layout + 8 * 1039
    # every flat cell owned by exactly one block, the ranges balanced
    # within one cell
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == cells
    for (_, e), (s2, _) in zip(plan.ranges, plan.ranges[1:]):
        assert e == s2
    lens = [e - s2 for s2, e in plan.ranges]
    assert max(lens) - min(lens) <= 1 and min(lens) >= nn
    assert max(lens) == cap
    assert list(op.range_starts(plan)) == [lo for lo, _ in plan.ranges] + [cells]
    # every neighbour of an interior cell in its own or an adjacent range
    owner = np.repeat(np.arange(blocks), lens)
    x, y, z = np.meshgrid(*(np.arange(1, n - 1),) * 3, indexing="ij")
    c = ((x * n + y) * n + z).ravel()
    for d in (1, n, nn):
        for nb in (c + d, c - d):
            assert np.abs(owner[nb] - owner[c]).max() <= 1


def _check_plane_plan(n, plan, bufs=2):
    """The plane route's plan of an n^3 grid: a block of whole planes
    each, in order, covering the grid; every +-1, +-n neighbour of an
    interior cell in its own range and every +-n^2 one in an adjacent
    range; the layout (``bufs`` plane buffers) within a block's shared
    memory and the blocks within the H100's 132 SMs."""
    nn, cells = n * n, n ** 3
    assert plan.route == "planes" and plan.blocks == n <= 132
    assert len(plan.ranges) == plan.blocks
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == cells
    for b, (lo, hi) in enumerate(plan.ranges):
        assert (lo, hi) == (b * nn, (b + 1) * nn)  # whole planes
    assert list(op.range_starts(plan)) == [lo for lo, _ in plan.ranges] + [cells]
    owner = np.repeat(np.arange(plan.blocks), nn)
    x, y, z = np.meshgrid(*(np.arange(1, n - 1),) * 3, indexing="ij")
    c = ((x * n + y) * n + z).ravel()
    for d, dist in ((1, 0), (n, 0), (nn, 1)):
        for nb in (c + d, c - d):
            assert (np.abs(owner[nb] - owner[c]) == dist).all()
    # buffers of [lead | plane | 1,024 | lead], the lead >= n + 1 (the
    # rows above and below load in bounds), 8 floats ahead
    lead = (n + 4) // 4 * 4
    assert lead >= n + 1
    layout = 4 * (8 + bufs * (2 * lead + nn + 1024))
    assert layout <= plan.smem_bytes <= layout + 4 * bufs * 3
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    # an exchange slot holds a plane and the last iteration's loads
    assert nn + 1024 <= op.plane_stride(n) <= nn + 1039
    assert op.plane_stride(n) % 4 == 0


@settings(max_examples=100, deadline=None)
@given(n=st.integers(3, 130))
def test_plane_schedule_covers_the_grid_and_fits(n):
    """The plane route serves every grid from n = 3 (the route launcher
    takes it at rooms the cluster route also serves)."""
    _check_plane_plan(n, op.plane_schedule(n))


def test_plane_schedule_refuses_grids_without_a_build():
    assert op.plane_schedule(139).blocks == 139  # 19,321 cells a plane
    for n in (2, 140):
        with pytest.raises(ValueError, match="no plane kernel"):
            op.plane_schedule(n)
    # the field form's builds go up to 17 cells a thread (17,161 a plane)
    assert op.plane_schedule(131, "field").blocks == 131
    for n in (2, 132):
        with pytest.raises(ValueError, match="no plane kernel"):
            op.fdtd_schedule(n, "field")


@pytest.mark.parametrize("room,smem", [(66, 46_368), (82, 66_080),
                                       (128, 145_536)])
def test_plane_schedule_pins_rooms(room, smem):
    """Rooms 66 (the first past the cluster route), 82 (chip_smoke.py's
    FDTD_COOP) and 128 (the largest the config allows) take the plane
    route: a block a plane, n <= 130 blocks on the H100's 132 SMs."""
    n = op.grid_n(room)
    plan = op.fdtd_schedule(n, "div")
    assert plan == op.plane_schedule(n)
    assert plan.route == "planes" and plan.blocks == n
    assert plan.ranges[1] == (n * n, 2 * n * n)
    assert plan.smem_bytes == smem


@pytest.mark.parametrize("form", ["div", "field"])
def test_schedule_pins_the_chip_smoke_rooms(form):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    plan = op.fdtd_schedule(op.grid_n(50), form)
    assert (82, 32) in chip_smoke.FDTD_SHAPES
    assert (128, 32) in chip_smoke.FDTD_SHAPES
    assert op.fdtd_schedule(op.grid_n(82), form).route == "planes"
    if form == "div":
        assert plan.route == "cluster" and plan.blocks == 16
        assert plan.ranges[1] == (8788, 17576)  # 52^3 / 16 cells a block
        assert plan.smem_bytes == 121_888
        # rooms up to 65 fit (67^3 / 16 cells a block and two halos)
        assert op.fdtd_schedule(op.grid_n(65), form).route == "cluster"
        assert op.fdtd_schedule(op.grid_n(66), form).route == "planes"
        assert op.fdtd_schedule(op.grid_n(128), form).route == "planes"
    else:
        # room 50: 52 planes of 2,704 cells, 3 a thread, the faces in
        # registers and two p buffers, as up to 7 a thread (room 82: 84
        # planes of 7,056); room 83 on: one p buffer, vy and vz in shared
        # memory; room 128: 130 planes, 17 cells a thread, three buffers
        # of 18,188 floats
        assert plan == op.plane_schedule(op.grid_n(50), "field")
        assert plan.blocks == 52 and plan.ranges[1] == (2704, 5408)
        assert plan.smem_bytes == 30_752
        assert op.fdtd_schedule(op.grid_n(82), form).smem_bytes == 66_080
        assert op.fdtd_schedule(op.grid_n(83), form).smem_bytes == 101_168
        assert op.fdtd_schedule(op.grid_n(128), form).smem_bytes == 218_288
        assert op.fdtd_schedule(op.grid_n(128), form).blocks == 130
    with pytest.raises(ValueError, match="form"):
        op.fdtd_schedule(52, "faces")


def test_route_launchers_take_cuda_tensors_only(rng):
    n, src, rcv = _geometry(8)
    x = _t(_x(rng, 4))
    with pytest.raises(ValueError, match="CUDA"):
        op.fdtd3d_block_div_cluster(x, *op.zero_fields_div(n), src, rcv)
    with pytest.raises(ValueError, match="CUDA"):
        op.fdtd3d_block_div_coop(x, *op.zero_fields_div(n), src, rcv)


# -- a NumPy emulation of the cluster kernel's layout ---------------------
#
# Each block holds its range and halos at slot c - origin, as the kernel
# does; all blocks compute a substep from their own arrays, then hand the
# edge cells to the neighbours' halos. The results must be the twin's bit
# for bit: the layout, the ranges and the hand-offs lose or reorder
# nothing.

F32 = np.float32


def _coords(c, n):
    return c // (n * n), c // n % n, c % n


def _interior(c, n):
    x, y, z = _coords(c, n)
    return ((x > 0) & (x < n - 1) & (y > 0) & (y < n - 1) & (z > 0)
            & (z < n - 1))


def _emulate_div(x, p, div, src_cell, rcv_cell, plan):
    n = p.shape[0]
    nn, cells = n * n, n ** 3
    s = x.shape[1]
    srcs = op.source_row(_t(x)).numpy()
    p0 = p.ravel().copy()
    p0[src_cell] += srcs[0]
    d0 = np.where(_interior(np.arange(cells), n), div.ravel(), F32(0))
    blocks = []
    for st_, en in plan.ranges:
        org = st_ - nn  # slot of cell c is c - org, halos of nn each side
        c = np.arange(org, en + nn)
        buf = np.zeros((2, c.size), F32)
        ok = (c >= 0) & (c < cells)
        buf[0, ok] = p0[c[ok]]
        own = np.arange(st_, en)
        blocks.append(dict(start=st_, end=en, org=org, buf=buf, own=own,
                           dv=d0[own].copy(), inner=_interior(own, n)))
    out = np.empty((x.shape[0], s), F32)
    pre = F32(0)
    for k in range(3 * s):
        cur, nxt = k & 1, (k + 1) & 1
        for b in blocks:
            h = b["own"] - b["org"]
            q = b["buf"][cur]
            tot = (q[h + nn] + q[h - nn]) + (q[h + n] + q[h - n])
            tot = tot + (q[h + 1] + q[h - 1])
            d = (b["dv"] + F32(op.C6) * q[h]) - F32(op.K1) * tot
            v = np.where(b["inner"], q[h] - F32(op.K2) * d,
                         q[h] * F32(op.ABSORB))
            b["dv"] = np.where(b["inner"], d, b["dv"])
            if k % 3 == 2 and k // 3 + 1 < s and b["start"] <= src_cell < b["end"]:
                i = src_cell - b["start"]
                pre = v[i]
                v[i] = v[i] + srcs[k // 3 + 1]
            b["buf"][nxt, h] = v
        for lo, hi in zip(blocks, blocks[1:]):  # the hand-offs
            first = np.arange(hi["start"], hi["start"] + nn)
            lo["buf"][nxt, first - lo["org"]] = hi["buf"][nxt, first - hi["org"]]
            last = np.arange(lo["end"] - nn, lo["end"])
            hi["buf"][nxt, last - hi["org"]] = lo["buf"][nxt, last - lo["org"]]
        if k % 3 == 2:
            smp = k // 3
            b = next(b for b in blocks if b["start"] <= rcv_cell < b["end"])
            v = (pre if smp + 1 < s and rcv_cell == src_cell
                 else b["buf"][nxt, rcv_cell - b["org"]])
            out[:, smp] = v * F32(op.F_OUTPUT_SCALE)
    fin = (3 * s) & 1
    p_out = np.concatenate([b["buf"][fin, b["own"] - b["org"]] for b in blocks])
    d_out = np.concatenate([b["dv"] for b in blocks])
    return out, p_out.reshape(p.shape), d_out.reshape(p.shape)


# (room, samples, receiver): room 8 on 8 blocks of 125 cells, room 15 on
# 16 ragged ones (307 and 308), receivers on the source cell and on a
# range boundary.
EMULATION_CASES = [(8, 5, "default"), (15, 4, "default"), (8, 7, "source"),
                   (15, 3, "boundary")]


def _emulation_case(room, receiver):
    n, src, rcv = _geometry(room)
    plan = op.fdtd_schedule(n, "div")
    if receiver == "source":
        rcv = src
    elif receiver == "boundary":
        c = plan.ranges[3][0]
        rcv = (c // (n * n), c // n % n, c % n)
    return n, src, rcv, plan


@pytest.mark.parametrize("room,s,receiver", EMULATION_CASES)
def test_div_cluster_layout_matches_twin_bit_for_bit(rng, room, s, receiver):
    n, src, rcv, plan = _emulation_case(room, receiver)
    assert plan.route == "cluster"
    x = _x(rng, s)
    fields = [f.numpy() for f in op.zero_fields_div(n)]
    twin = op.zero_fields_div(n)
    for _ in range(2):
        got = _emulate_div(x, *fields, op.flat_cell(src, n),
                           op.flat_cell(rcv, n), plan)
        want = op.fdtd3d_block_div_plain(_t(x), *twin, src, rcv)
        assert np.array_equal(got[0], want[0][:1].numpy()[0][None].repeat(
            x.shape[0], 0))
        for a, b in zip(got[1:], want[1:]):
            assert np.array_equal(a, b.numpy())
        fields, twin = list(got[1:]), want[1:]
    assert np.abs(got[0]).max() > 0


# -- a NumPy emulation of the plane kernel's layout and hand-off ---------
#
# Each block holds its plane (two buffers), p and div of its cells and a
# flag; the exchange has two parities of n + 2 plane slots, plane b at
# slot b + 1, the two unwritten slots NaN. A block may run substep k once
# both neighbours' flags reach k - lag (lag 0 is the kernel's rule); the
# blocks run one substep at a time in an order that rule allows, random or
# greedy (always the lowest block it allows). Substep k reads the
# neighbours' slots of parity k & 1 and writes the block's own of parity
# (k + 1) & 1, then stores k + 1 in its flag. The results must be the
# twin's bit for bit in every allowed order: the layout, the exchange and
# the flag rule lose or reorder nothing.


def _emulate_planes(x, p, div, src_cell, rcv_cell, plan, order, lag=0):
    n = p.shape[0]
    nn, s = n * n, x.shape[1]
    substeps = 3 * s
    srcs = op.source_row(_t(x)).numpy()
    p0 = p.ravel().copy()
    p0[src_cell] += srcs[0]
    d0 = np.where(_interior(np.arange(n ** 3), n), div.ravel(), F32(0))
    xch = np.full((2, n + 2, nn), np.nan, F32)
    blocks = []
    for b, (lo, hi) in enumerate(plan.ranges):
        own = np.arange(lo, hi)
        blocks.append(dict(b=b, lo=lo, k=0, pre=F32(0), dv=d0[own].copy(),
                           inner=_interior(own, n),
                           buf=np.stack([p0[own], np.zeros(nn, F32)])))
        xch[0, b + 1] = p0[own]  # the prologue, before the grid sync
    flags = [0] * len(blocks)
    out = np.full((x.shape[0], s), np.nan, F32)

    def receivers(blk, smp, cur):
        if blk["lo"] <= rcv_cell < blk["lo"] + nn:
            v = (blk["pre"] if smp + 1 < s and rcv_cell == src_cell
                 else cur[rcv_cell - blk["lo"]])
            out[:, smp] = v * F32(op.F_OUTPUT_SCALE)

    def substep(blk):
        b, k = blk["b"], blk["k"]
        q = (k + 1) & 1
        cur = blk["buf"][k & 1]
        if k > 0 and k % 3 == 0:
            receivers(blk, k // 3 - 1, cur)
        pad = np.concatenate([np.zeros(n + 1, F32), cur, np.zeros(n + 1, F32)])
        at = np.arange(nn) + n + 1
        with np.errstate(invalid="ignore"):
            tot = xch[k & 1, b + 2] + xch[k & 1, b]
            tot = tot + (pad[at + n] + pad[at - n])
            tot = tot + (pad[at + 1] + pad[at - 1])
            d = (blk["dv"] + F32(op.C6) * cur) - F32(op.K1) * tot
            v = np.where(blk["inner"], cur - F32(op.K2) * d,
                         cur * F32(op.ABSORB))
        blk["dv"] = np.where(blk["inner"], d, blk["dv"])
        if (k % 3 == 2 and k // 3 + 1 < s
                and blk["lo"] <= src_cell < blk["lo"] + nn):
            i = src_cell - blk["lo"]
            blk["pre"] = v[i]
            v[i] = v[i] + srcs[k // 3 + 1]
        blk["buf"][q] = v
        if k + 1 < substeps:
            xch[q, b + 1] = v
            flags[b] = k + 1
        blk["k"] = k + 1
        if blk["k"] == substeps:
            receivers(blk, s - 1, v)

    def allowed(blk):
        return blk["k"] < substeps and all(
            flags[nb] >= blk["k"] - lag
            for nb in (blk["b"] - 1, blk["b"] + 1) if 0 <= nb < len(blocks))

    while any(blk["k"] < substeps for blk in blocks):
        ready = [blk for blk in blocks if allowed(blk)]
        assert ready, "the flag rule deadlocked"
        substep(ready[0] if order is None else
                ready[order.integers(len(ready))])
    fin = substeps & 1
    p_out = np.concatenate([blk["buf"][fin] for blk in blocks])
    d_out = np.concatenate([blk["dv"] for blk in blocks])
    return out, p_out.reshape(p.shape), d_out.reshape(p.shape)


# (room, samples, receiver): rooms 8, 10, 13 and 14 (n = 10, 12, 15 and
# 16 planes; the cluster route takes these rooms, the plane route is
# forced), S odd and even, receivers on the source cell and on the first
# interior cell of a plane.
PLANE_EMULATION_CASES = [(8, 5, "default"), (10, 4, "source"),
                         (13, 3, "plane"), (14, 4, "default")]


def _plane_case(rng, room, s, receiver):
    n, src, rcv = _geometry(room)
    if receiver == "source":
        rcv = src
    elif receiver == "plane":
        rcv = (3, 1, 1)  # the first interior cell of block 3's plane
    return n, src, rcv, op.plane_schedule(n), _x(rng, s)


@pytest.mark.parametrize("room,s,receiver", PLANE_EMULATION_CASES)
def test_div_plane_layout_matches_twin_bit_for_bit(rng, room, s, receiver):
    n, src, rcv, plan, x = _plane_case(rng, room, s, receiver)
    for order in (np.random.default_rng(room), None):  # random, greedy
        fields = [f.numpy() for f in op.zero_fields_div(n)]
        twin = op.zero_fields_div(n)
        for _ in range(2):
            got = _emulate_planes(x, *fields, op.flat_cell(src, n),
                                  op.flat_cell(rcv, n), plan, order)
            want = op.fdtd3d_block_div_plain(_t(x), *twin, src, rcv)
            assert np.array_equal(got[0], want[0].numpy())
            for a, b in zip(got[1:], want[1:]):
                assert np.array_equal(a, b.numpy())
            fields, twin = list(got[1:]), want[1:]
        assert np.abs(got[0]).max() > 0


def test_div_plane_handoff_needs_both_flags(rng):
    """With the flag rule one substep looser, a block runs two substeps
    ahead of a neighbour and overwrites a slot that the neighbour has not
    yet read: the emulation then differs from the twin."""
    n, src, rcv, plan, x = _plane_case(rng, 8, 4, "default")
    p, div = (f.numpy() for f in op.zero_fields_div(n))
    args = (x, p, div, op.flat_cell(src, n), op.flat_cell(rcv, n), plan, None)
    want = op.fdtd3d_block_div_plain(_t(x), *op.zero_fields_div(n), src, rcv)
    good, loose = _emulate_planes(*args), _emulate_planes(*args, lag=1)
    assert np.array_equal(good[1], want[1].numpy())
    assert not np.array_equal(loose[1], want[1].numpy())


# -- a NumPy emulation of the field form's plane kernel ------------------
#
# Block b holds its plane's p (two buffers), its cells' lower faces vx[b],
# vy[b, :n] and vz[b, :, :n], and a replica of the faces above its plane,
# vx[b + 1]; only p crosses blocks, through the same two-parity exchange
# and flag rule as the divergence form's plane kernel (``lag``), the blocks
# run in a random or greedy order that the rule allows. The replica is
# updated from the neighbour's p as the owner updates its face: on every
# (y, z) while b + 1 <= n - 1 (``replica="interior"``: only where the
# owner's cell is interior, which must differ from the twin). Each block
# writes the rows of out that ``receiver_csr`` buckets to its plane. The
# results must be the twin's bit for bit.


def _emulate_field_planes(x, p, vx, vy, vz, src_cell, cells, order, lag=0,
                          replica="owner"):
    n = p.shape[0]
    nn, s = n * n, x.shape[1]
    substeps = 3 * s
    k1, k2 = F32(-op.K1), F32(op.K2)
    srcs = op.source_row(_t(x)).numpy()
    p0 = p.ravel().copy()
    p0[src_cell] += srcs[0]
    rows, starts = op.receiver_csr(cells, n)
    xch = np.full((2, n + 2, nn), np.nan, F32)
    blocks = []
    for b in range(n):
        own = np.arange(b * nn, (b + 1) * nn)
        if replica == "owner" or b + 1 >= n:
            upd = np.full(nn, b + 1 <= n - 1)
        else:
            upd = _interior(own + nn, n)
        blocks.append(dict(
            b=b, lo=b * nn, k=0, pre=F32(0), inner=_interior(own, n),
            buf=np.stack([p0[own], np.zeros(nn, F32)]), upd=upd,
            vx0=vx[b].ravel().copy(), vx1=vx[b + 1].ravel().copy(),
            vy=vy[b, :n].copy(), vz=vz[b, :, :n].copy(),
            rows=rows[starts[b]:starts[b + 1]]))
        xch[0, b + 1] = p0[own]
    flags = [0] * n
    out = np.full((x.shape[0], s), np.nan, F32)

    def receivers(blk, smp, cur):
        for t in blk["rows"]:
            v = (blk["pre"] if smp + 1 < s and cells[t] == src_cell
                 else cur[cells[t] - blk["lo"]])
            out[t, smp] = v * F32(op.F_OUTPUT_SCALE)

    def substep(blk):
        b, k = blk["b"], blk["k"]
        q = (k + 1) & 1
        cur = blk["buf"][k & 1]
        if k > 0 and k % 3 == 0:
            receivers(blk, k // 3 - 1, cur)
        c2 = cur.reshape(n, n)
        with np.errstate(invalid="ignore"):
            if b >= 1:
                blk["vx0"] = blk["vx0"] + k1 * (cur - xch[k & 1, b])
            blk["vx1"] = np.where(
                blk["upd"], blk["vx1"] + k1 * (xch[k & 1, b + 2] - cur),
                blk["vx1"])
        blk["vy"][1:] = blk["vy"][1:] + k1 * (c2[1:] - c2[:-1])
        blk["vz"][:, 1:] = blk["vz"][:, 1:] + k1 * (c2[:, 1:] - c2[:, :-1])
        vy_up = np.concatenate([blk["vy"][1:], blk["vy"][:1]])
        vz_up = np.concatenate([blk["vz"][:, 1:], blk["vz"][:, :1]], axis=1)
        with np.errstate(invalid="ignore"):
            d = ((blk["vx1"] - blk["vx0"])
                 + (vy_up - blk["vy"]).ravel()) + (vz_up - blk["vz"]).ravel()
        v = np.where(blk["inner"], cur - k2 * d, cur * F32(op.ABSORB))
        if (k % 3 == 2 and k // 3 + 1 < s
                and blk["lo"] <= src_cell < blk["lo"] + nn):
            i = src_cell - blk["lo"]
            blk["pre"] = v[i]
            v[i] = v[i] + srcs[k // 3 + 1]
        blk["buf"][q] = v
        if k + 1 < substeps:
            xch[q, b + 1] = v
            flags[b] = k + 1
        blk["k"] = k + 1
        if blk["k"] == substeps:
            receivers(blk, s - 1, v)

    def allowed(blk):
        return blk["k"] < substeps and all(
            flags[nb] >= blk["k"] - lag
            for nb in (blk["b"] - 1, blk["b"] + 1) if 0 <= nb < n)

    while any(blk["k"] < substeps for blk in blocks):
        ready = [blk for blk in blocks if allowed(blk)]
        assert ready, "the flag rule deadlocked"
        substep(ready[0] if order is None else
                ready[order.integers(len(ready))])
    fin = substeps & 1
    p_out = np.concatenate([blk["buf"][fin] for blk in blocks])
    p_out = p_out.reshape(p.shape)
    vx_out = np.concatenate([np.stack([blk["vx0"] for blk in blocks]),
                             vx[n].reshape(1, nn)]).reshape(vx.shape)
    vy_out, vz_out = vy.copy(), vz.copy()
    for blk in blocks:
        vy_out[blk["b"], :n] = blk["vy"]
        vz_out[blk["b"], :, :n] = blk["vz"]
    return out, p_out, vx_out, vy_out, vz_out


# (room, samples, receivers): rooms 1, 8 and 15 (n = 3, 10 and 17
# planes), and room 128, the largest the config allows (130 planes, 17
# cells a thread); S odd and even; receivers "line" (a line of 7 across x,
# track 2 moved onto the source cell) or "broadcast" (every track reads
# the room's receiver).
FIELD_PLANE_CASES = [(1, 3, "line"), (8, 4, "broadcast"), (8, 5, "line"),
                     (15, 3, "line"), (15, 2, "broadcast"), (128, 1, "line")]


def _field_plane_case(rng, room, s, receivers):
    n, src, rcv = _geometry(room)
    tracks = 7
    if receivers == "broadcast":
        cells = np.full(tracks, op.flat_cell(rcv, n), np.int64)
    else:
        xs, ys, zs = op.receiver_line(tracks, n)
        cells = (xs.astype(np.int64) * n + ys) * n + zs
        cells[2] = op.flat_cell(src, n)
    return n, src, rcv, cells, _x(rng, s, tracks)


def _field_fields(rng, n, scale):
    """Random starting fields (a ringing room): p, vx, vy, vz."""
    return [(rng.random(shape, dtype=np.float32) * scale).astype(np.float32)
            for shape in ((n, n, n), (n + 1, n, n), (n, n + 1, n),
                          (n, n, n + 1))]


def _twin_field(x, fields, src, rcv, cells, receivers):
    got = op.fdtd3d_block_field_plain(
        _t(x), *(_t(f) for f in fields), src, rcv,
        receivers=(None if receivers == "broadcast"
                   else _t(cells.astype(np.int32))))
    return [g.numpy() for g in got]


@pytest.mark.parametrize("room,s,receivers", FIELD_PLANE_CASES)
def test_field_plane_layout_matches_twin_bit_for_bit(rng, room, s,
                                                     receivers):
    n, src, rcv, cells, x = _field_plane_case(rng, room, s, receivers)
    assert op.fdtd_schedule(n, "field").route == "planes"
    orders = [np.random.default_rng(room), None]  # random, greedy
    for order in orders if room < 100 else orders[1:]:
        start = _field_fields(np.random.default_rng(s), n, 1e-3)
        mine, twin = start, start
        for _ in range(2):
            got = _emulate_field_planes(x, *mine, op.flat_cell(src, n),
                                        cells, order)
            want = _twin_field(x, twin, src, rcv, cells, receivers)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
            mine, twin = got[1:], want[1:]
        assert np.abs(got[0]).max() > 0
        if receivers == "line" and room > 1:  # room 1 has one interior cell
            assert len(set(got[0][:, -1].tolist())) > 1


def test_field_plane_handoff_needs_both_flags(rng):
    """With the flag rule one substep looser, a block overwrites an
    exchange slot its neighbour has not read: the field form's emulation
    then differs from the twin."""
    n, src, rcv, cells, x = _field_plane_case(rng, 8, 4, "line")
    fields = _field_fields(np.random.default_rng(1), n, 1e-3)
    want = _twin_field(x, fields, src, rcv, cells, "line")
    args = (x, *fields, op.flat_cell(src, n), cells, None)
    good, loose = _emulate_field_planes(*args), _emulate_field_planes(
        *args, lag=1)
    assert np.array_equal(good[1], want[1])
    assert not np.array_equal(loose[1], want[1])


def test_field_plane_replica_follows_its_owner(rng):
    """A replica of vx[b + 1] updated only where its owner's cell is
    interior misses the owner's updates on the last plane (all boundary),
    which the interior cells of plane n - 2 read: p differs from the
    twin."""
    n, src, rcv, cells, x = _field_plane_case(rng, 8, 4, "line")
    fields = _field_fields(np.random.default_rng(2), n, 1e-3)
    want = _twin_field(x, fields, src, rcv, cells, "line")
    args = (x, *fields, op.flat_cell(src, n), cells, None)
    good = _emulate_field_planes(*args)
    interior_only = _emulate_field_planes(*args, replica="interior")
    assert all(np.array_equal(a, b) for a, b in zip(good, want))
    assert not np.array_equal(interior_only[1], want[1])


def test_receiver_csr_buckets_rows_by_plane():
    n = 5
    cells = np.array([3 * 25 + 7, 0, 4 * 25, 3 * 25, 124, 26])
    order, starts = op.receiver_csr(cells, n)
    assert order.dtype == np.int32 and len(starts) == n + 1
    assert starts == [0, 1, 2, 2, 4, 6]
    assert order.tolist() == [1, 5, 0, 3, 2, 4]  # stable within a plane
    for b in range(n):
        assert all(cells[t] // 25 == b for t in order[starts[b]:starts[b + 1]])
    for bad in ([-1], [125]):
        with pytest.raises(ValueError, match="outside"):
            op.receiver_csr(np.array(bad), n)
