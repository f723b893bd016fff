"""The port's program exporter (``gpuaudiobench_tpu_torch/tools/
export_programs.py``) and its ``gpuab`` operators (``ops/gpuab.py``,
``csrc/torch_ops.cc``) on the CPU:

* each of the eight specs is the one the JAX exporter's programs imply
  (``tools/export_stablehlo.py:_programs``), line for line, computed
  without compiling;
* ``lcg_inputs`` is the runner's LCG (``tests/test_pjrt_runner.py:
  _lcg_checksum``), across inputs, blocks and the S32 rule;
* each program's port function against the JAX exporter's function on
  the LCG inputs at 8 tracks (the headline at 4,096 modes, FDTD at room
  8), at its benchmark's tolerance relative to the reference's peak, with
  the same non-finite mask (the LCG's noise drives the modal rotations and
  the IIR filter past the float32 range; ``iirfilter`` is held on the first
  64 samples of each track; ``modal`` returns its input states, where the
  JAX exporter's XLA form returns the rotated ones);
* the operator library builds on the CPU with its six schemas, its CPU
  implementations are the twins, and a CPU program calls the operators;
* the ``modal`` program, exported and compiled by AOTInductor, equals the
  eager twin in this process (``aoti_load_package``);
* a field step with per-track receivers exports: the program holds the
  bucketing and the field operators and takes the receivers as an input,
  and equals the eager call bit for bit, receivers off the grid among
  them.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.ops import modal_pallas as mp
from gpuaudiobench_tpu.ops.fdtd3d_pallas import fdtd3d_block_pallas_div
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.ops import conv, fdtd3d, gpuab, iir, modal
from gpuaudiobench_tpu_torch.tools import export_programs as ep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKS = 8
HEADLINE = 4096
ROOM = 8
# Each program's benchmark tolerance (models/*.py), relative to the peak.
TOLERANCE = {"modal_pallas": 1e-4, "fdtd3d_pallas": 5e-3, "gain": 1e-5,
             "iirfilter": 1e-4, "modal": 1e-4, "conv1d": 1e-3,
             "partconv": 1e-3, "session": 1e-3}
IIR_HEAD = 64


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_exporter():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        yield _load(os.path.join(ROOT, "tools", "export_stablehlo.py"),
                    "export_stablehlo")
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))


def _small():
    return dataclasses.replace(BenchConfig(), n_tracks=TRACKS)


def test_names_are_the_jax_exporters(jax_exporter):
    progs = jax_exporter._programs(JaxConfig())
    progs.pop("_jnp")
    assert sorted(ep.NAMES) == sorted(progs)


@pytest.mark.parametrize("name", ep.NAMES)
def test_spec_is_the_jax_exporters(jax_exporter, name):
    """Line for line: the JAX exporter writes ``f32 d0 d1 ...`` for each of
    its program's inputs after its ``#`` line."""
    _, args = jax_exporter._programs(JaxConfig())[name]
    want = [f"f32 {' '.join(str(d) for d in a.shape)}".rstrip() for a in args]
    _, spec = ep.programs()[name]
    lines = ep.spec_text(name, spec).splitlines()
    assert lines[0] == f"# inputs for {name} (native_runner --spec)"
    assert lines[1:] == want


def test_session_bakes_the_benchmarks_eq(jax_exporter):
    """The EQ is the module's constant, the JAX exporter's pinned
    low-passes; the spec has no coefficient input."""
    module, spec = ep.make_program("session", "cpu")
    assert torch.equal(module.coeffs, torch.from_numpy(
        ep.session_coefficients()))
    assert ("f32", (4, 5)) not in spec and len(spec) == 9


def _scalar_lcg(count, state=42):
    out = []
    for _ in range(count):
        state = (state * 6364136223846793005 + 1442695040888963407) % 2**64
        out.append(np.float32(2.0 * ((state >> 33) & 0xFFFFFF) / 16777216.0
                              - 1.0))
    return np.array(out, np.float32), state


def test_lcg_is_the_runners():
    pjrt = _load(os.path.join(ROOT, "tests", "test_pjrt_runner.py"),
                 "test_pjrt_runner_lcg")
    vals, _ = ep.lcg_values(64)
    total = 0.0
    for v in vals:
        total += float(np.float32(2.0) * v)
    assert total == pjrt._lcg_checksum()
    # Across the vectorised blocks and from one input to the next.
    n = (1 << 16) + 300
    want, state = _scalar_lcg(n)
    got, got_state = ep.lcg_values(n)
    assert np.array_equal(got, want) and got_state == state
    a, b = ep.lcg_inputs([("f32", (100, 7)), ("f32", (n - 700,))])
    assert np.array_equal(np.concatenate([a.numpy().ravel(), b.numpy()]),
                          want)


def test_lcg_int32_rule():
    (ints,) = ep.lcg_inputs([("i32", (64,))])
    vals, _ = _scalar_lcg(64)
    want = ((vals * np.float32(0.5) + np.float32(0.5))
            * np.float32(1000.0)).astype(np.int32)
    assert ints.dtype == torch.int32 and np.array_equal(ints.numpy(), want)


def _jax_functions(jax_exporter, cfg):
    """name -> the JAX exporter's function of the inputs at ``cfg``, the
    headline and FDTD at this file's reduced sizes, each through its CPU
    path (Pallas in interpret mode)."""
    progs = jax_exporter._programs(cfg)
    src, rcv = fdtd3d.source_pos(ROOM), fdtd3d.receiver_pos(ROOM)
    fns = {name: prog[0] for name, prog in progs.items() if name != "_jnp"}
    tile = mp.stream_tile(HEADLINE, ep.HEADLINE_TRACKS)
    fns["modal_pallas"] = lambda cw, sw, re, im: mp.modal_folded_step(
        cw, sw, re, im, cfg.buffer_size, ep.HEADLINE_TRACKS, tile)
    fns["fdtd3d_pallas"] = lambda x, p, d: fdtd3d_block_pallas_div(
        x, p, d, source=src, receiver=rcv)
    return fns


def _close(got, want, tol, label):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite), label
    if finite.any():
        peak = np.abs(want[finite]).max()
        err = np.abs(got[finite] - want[finite]).max()
        assert err <= tol * peak, (label, err, peak)


@pytest.mark.parametrize("name", ep.NAMES)
def test_port_function_matches_the_jax_one(jax_exporter, name):
    cfg = _small()
    module, spec = ep.make_program(name, "cpu", cfg, headline_modes=HEADLINE,
                                   fdtd_room=ROOM)
    inputs = ep.lcg_inputs(spec)
    fn = _jax_functions(jax_exporter, JaxConfig(n_tracks=TRACKS))[name]
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(x.numpy() for x in inputs))
    got = module(*inputs)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if name == "iirfilter" and k == 0:
            _close(g[:, :IIR_HEAD], w[:, :IIR_HEAD], TOLERANCE[name], name)
            assert np.array_equal(np.isfinite(g), np.isfinite(w))
        elif name == "modal" and k > 0:
            # The JAX exporter's XLA form returns the rotated states; the
            # port's kernel keeps the Metal-parity contract and returns the
            # input states unchanged.
            assert np.array_equal(g, inputs[k + 2].numpy())
        else:
            _close(g, w, TOLERANCE[name], f"{name} output {k}")


def test_ops_library_builds_with_the_six_schemas():
    ops = gpuab.load()
    for name in gpuab.OPS:
        assert getattr(ops, name).default._schema.name == f"gpuab::{name}"
    sig = str(ops.fdtd_div_planes_launch.default._schema)
    assert "int[] starts" in sig and "Tensor(a!)" not in sig
    # Built without the CUDA part here: no CUDA implementation registered.
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(
        "gpuab::conv1d_direct_launch", "CUDA")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        "gpuab::conv1d_direct_launch", "CPU")


def test_cpu_implementations_are_the_twins(rng):
    ops = gpuab.load()
    x = torch.from_numpy(rng.standard_normal((4, 40), np.float32))
    ir = torch.from_numpy(rng.standard_normal((4, 9), np.float32))
    for mode in conv.EDGE_MODES:
        assert torch.equal(ops.conv1d_direct_launch(x, ir, mode == "bleed"),
                           conv.conv1d_direct_plain(x, ir, mode))
    c = torch.tensor([0.2, 0.3, 0.1, -0.4, 0.2])
    z = torch.from_numpy(rng.standard_normal((4, 2), np.float32))
    for g, w in zip(ops.iir_biquad_launch(x, c, z),
                    iir.iir_biquad_plain(x, c, z)):
        assert torch.equal(g, w)
    cc, zz = c.repeat(3, 1), z.repeat(3, 1, 1)
    for g, w in zip(ops.iir_cascade_launch(x, cc, zz, 0, 0, 0, 0),
                    iir.iir_cascade_plain(x, cc, zz)):
        assert torch.equal(g, w)
    m = 256
    tabs = [torch.from_numpy(rng.random(m, np.float32)) for _ in range(5)]
    out, re2, im2 = ops.modal_bank_launch(tabs[1], tabs[2], tabs[0], tabs[3],
                                          tabs[4], 16, 8, True, False, 0, 0, 0)
    assert torch.equal(out, modal.modal_bank_plain(*tabs, 16, 8)[0])
    assert re2.numel() == 0 and im2.numel() == 0
    got = ops.modal_bank_launch(tabs[1], tabs[2], None, tabs[3], tabs[4], 16,
                                8, False, True, 0, 0, 0)
    for g, w in zip(got, modal.modal_folded_step_plain(*tabs[1:], 16, 8)):
        assert torch.equal(g, w)
    n = fdtd3d.grid_n(ROOM)
    xs = torch.from_numpy(rng.standard_normal((3, 12), np.float32))
    p, d = (torch.from_numpy(rng.standard_normal((n, n, n), np.float32))
            for _ in range(2))
    src, rcv = fdtd3d.source_pos(ROOM), fdtd3d.receiver_pos(ROOM)
    want = fdtd3d.fdtd3d_block_div_plain(xs, p, d, src, rcv)
    for name in ("fdtd_div_cluster_launch", "fdtd_div_planes_launch"):
        got = getattr(ops, name)(
            fdtd3d.source_row(xs), p, d, 3, fdtd3d.flat_cell(src, n),
            fdtd3d.flat_cell(rcv, n), fdtd3d.K1, fdtd3d.K2, fdtd3d.C6,
            fdtd3d.ABSORB, fdtd3d.F_OUTPUT_SCALE, [0, n ** 3])
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name,op", [
    ("modal_pallas", "modal_bank_launch"),
    ("fdtd3d_pallas", "fdtd_div_cluster_launch"),
    ("iirfilter", "iir_biquad_launch"), ("modal", "modal_bank_launch"),
    ("conv1d", "conv1d_direct_launch"), ("session", "iir_cascade_launch")])
def test_exported_cpu_program_calls_the_operator(name, op):
    """Traced on the CPU, a wrapper calls its operator (not the unrolled
    twin), and a trace counts no launch."""
    gpuab.load()
    module, spec = ep.make_program(name, "cpu", _small(),
                                   headline_modes=HEADLINE, fdtd_room=ROOM)
    before = {m: dict(m.KERNEL_LAUNCHES) for m in (modal, iir, conv, fdtd3d)}
    prog = torch.export.export(module, tuple(ep.lcg_inputs(spec)))
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert f"gpuab.{op}.default" in targets
    assert len(targets) < 40  # the kernel is one node, not a sample loop
    assert {m: dict(m.KERNEL_LAUNCHES) for m in before} == before


class _FieldStep(torch.nn.Module):
    """One field-form block with per-track receivers, the receivers an
    input of the program."""

    def __init__(self, room):
        super().__init__()
        self.src = fdtd3d.source_pos(room)
        self.rcv = fdtd3d.receiver_pos(room)

    def forward(self, x, p, vx, vy, vz, receivers):
        return fdtd3d.fdtd3d_block_field(x, p, vx, vy, vz, self.src,
                                         self.rcv, receivers=receivers)


def test_per_track_field_step_exports(rng):
    gpuab.load()
    n = fdtd3d.grid_n(ROOM)
    x = torch.from_numpy(rng.standard_normal((4, 16), np.float32))
    fields = fdtd3d.zero_fields(n)
    fields[0][3, 4, 5] = 0.5  # a ringing room
    rcv = torch.tensor([503, -1, 7, 100], dtype=torch.int32)
    before = dict(fdtd3d.KERNEL_LAUNCHES)
    prog = torch.export.export(_FieldStep(ROOM), (x, *fields, rcv))
    targets = [str(nd.target) for nd in prog.graph.nodes
               if nd.op == "call_function"]
    assert "gpuab.fdtd_receiver_buckets.default" in targets
    assert "gpuab.fdtd_field_planes_launch.default" in targets
    assert len(targets) < 40
    assert fdtd3d.KERNEL_LAUNCHES == before
    for cells in ([503, -1, 7, 100], [0, 1040, -1009, 12], [12, 7, 3, 900]):
        r = torch.tensor(cells, dtype=torch.int32)
        got = prog.module()(x, *fields, r)
        want = _FieldStep(ROOM)(x, *fields, r)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), cells
    assert fdtd3d.KERNEL_LAUNCHES == before


@pytest.fixture(scope="module")
def modal_package(tmp_path_factory):
    out = tmp_path_factory.mktemp("export")
    cfg = dataclasses.replace(BenchConfig(), n_tracks=4, buffer_size=64)
    times = ep.export("modal", str(out), "cpu", cfg)
    return out, cfg, times


def test_modal_package_equals_the_eager_twin(modal_package):
    out, cfg, times = modal_package
    assert times["export_s"] >= 0 and times["compile_s"] > 0
    assert (out / "modal.spec").read_text() == ep.spec_text(
        "modal", ep.programs(cfg)["modal"][1])
    module, spec = ep.make_program("modal", "cpu", cfg)
    inputs = ep.lcg_inputs(spec)
    got = torch._inductor.aoti_load_package(str(out / "modal.pt2"))(*inputs)
    tabs = inputs
    want = modal.modal_bank_plain(*tabs, cfg.buffer_size, cfg.n_tracks)[0]
    peak = want.abs().max().item()
    assert got[0].shape == want.shape
    assert (got[0] - want).abs().max().item() <= 1e-6 * peak
    # The Metal-parity contract: the input states come back unchanged.
    assert torch.equal(got[1], inputs[3]) and torch.equal(got[2], inputs[4])
    assert ep.checksum(got[0]) == ep.checksum(want)


def test_main_refuses_an_unknown_name(capsys, tmp_path):
    assert ep.main(["--out", str(tmp_path), "nope"], device="cpu") == 1
    assert "unknown program" in capsys.readouterr().err


def test_main_needs_the_card_unless_asked_for_the_cpu(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert ep.main(["--out", str(tmp_path), "gain"]) == 1
    assert "CUDA requested" in capsys.readouterr().err
