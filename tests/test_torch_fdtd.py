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
  reference's bar, tests/test_pallas_ops.py:33);
* the divergence twin against ``fdtd3d_block_pallas_div`` (div' too) and
  against the field twin: 1e-5 (the divergence form reassociates the
  update; the reference's bar, tests/test_benchmarks.py:189);
* benchmark outputs, port vs JAX: 1e-5; goldens bit for bit.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
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
