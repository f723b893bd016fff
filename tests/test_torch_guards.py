"""Guards of the PyTorch port: it never imports jax or the JAX package
(``gpuaudiobench_tpu``), never falls back
from the GPU to the CPU or from the kernel to its plain twin, rejects
what its kernel does not take, and raises for what is not ported."""

import dataclasses
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu import registry as jax_registry
from gpuaudiobench_tpu_torch import bench, registry
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.ops import modal as tops
from gpuaudiobench_tpu_torch.utils import device as dev

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gpuaudiobench_tpu_torch"
CPU = torch.device("cpu")

BLOCKED_JAX = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "gpuaudiobench_tpu")

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    import gpuaudiobench_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    for mod in ("models.datatransfer", "harness.dawsim", "harness.overlap",
                "utils.native", "ops.partconv", "models.partconv",
                "models.session", "harness.graph", "ops.neuralamp",
                "models.neuralamp", "harness.checkpoint", "tools.soak",
                "tools.capacity", "tools.build_capacity_ledger",
                "tools.merge_capacity", "tools.overlap64_attrib",
                "webui.params", "webui.server", "webui.__main__",
                "utils.published", "parallel.mesh", "parallel.collectives",
                "parallel.launch", "parallel.multichip", "parallel.ranks",
                "parallel.fdtd_sharded", "parallel.partconv_sharded",
                "parallel.neuralamp_sharded", "models.multichip_bench",
                "analysis.compare", "tools.campaign", "tools.modal_sweep",
                "tools.rndmem_sweep", "tools.transfer_tab5",
                "tools.dawsim_campaign", "tools.lowlatency_sweep",
                "tools.satreps_campaign", "tools.report",
                "tools.compare_runs", "tools.doctor",
                "examples.streaming_synth", "examples.room_impulse",
                "examples.reverb", "examples.ampsim", "examples.session",
                "examples.multichip_synth", "tools.json_to_csv",
                "tools.render_results", "tools.remeasure_rows",
                "tools.regen_artifacts", "tools.readme_headline",
                "tools.overlap_campaign", "tools.latency_attrib",
                "tools.mesh_scaling", "ops.gpuab", "tools.export_programs",
                "tools.binding_ab"):
        assert "gpuaudiobench_tpu_torch." + mod in names, mod

    import torch
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    cfg = BenchConfig(n_tracks=8, buffer_size=64, n_runs=2, warmup=1,
                      device_timing=False, pipeline_depth=4, saturated_reps=2)
    for name, knobs in [("ModalFilterBank", {}), ("IIRFilter", {}),
                        ("IIRFilter", {"iir_form": "blockstate"}),
                        ("BiquadChain", {"device_timing": True}),
                        ("ModalFilterBank", {"n_tracks": 12}),
                        ("NoOp", {}), ("gain", {}), ("GainStats", {}),
                        ("FFT1D", {}), ("Conv1D", {"ir_length": 40}),
                        ("Conv1D", {"ir_length": 100,
                                    "conv_edge_mode": "bleed"}),
                        ("Conv1D_accel", {"ir_length": 40}),
                        ("RndMemRead", {"rndmem_pool_mb": 1}),
                        ("DWG1DNaive", {"dwg_min_length": 20,
                                        "dwg_max_length": 200}),
                        ("DWG1DAccel", {"dwg_max_length": 300}),
                        ("FDTD3D", {"fdtd_room": 8, "buffer_size": 16}),
                        ("FDTD3D", {"fdtd_room": 8, "buffer_size": 16,
                                    "fdtd_per_track_receivers": True}),
                        ("SOL_VPU", {"sol_fma_k": 8, "sol_fma_mib": 1}),
                        ("SOL_VMEM", {"sol_fma_k": 8, "sol_vmem_mib": 1}),
                        ("SOL_HBM", {"sol_stream_mib": 1}),
                        ("SOL_MXU_bf16", {"sol_matmul_dim": 64}),
                        ("SOL_MXU_f32", {"sol_matmul_dim": 64}),
                        ("SOL_MXU_int8", {"sol_matmul_dim": 64}),
                        ("datacopy0199", {"transfer_mib": 1,
                                          "dawsim": True}),
                        ("datacopy9901", {"transfer_mib": 1,
                                          "overlap_depth": 4,
                                          "overlap_reps": 1}),
                        ("IIRFilter", {"overlap_depth": 4,
                                       "overlap_reps": 1}),
                        ("PartConv", {"ir_length": 300}),
                        ("PartConv", {"ir_length": 300,
                                      "partconv_form": "ring",
                                      "partconv_h_dtype": "f16"}),
                        ("PartConv", {"ir_length": 300,
                                      "partconv_form": "nupols",
                                      "partconv_tail_chunk": 2,
                                      "overlap_depth": 4,
                                      "overlap_reps": 1}),
                        ("DAWSessionMix", {"ir_length": 300,
                                           "session_eq_stages": 16,
                                           "overlap_depth": 4,
                                           "overlap_reps": 1}),
                        ("NeuralAmp", {"neuralamp_channels": 16,
                                       "neuralamp_layers": 3,
                                       "neuralamp_dtype": "int8"}),
                        ("NeuralAmpLSTM", {"neuralamp_channels": 16,
                                           "neuralamp_dtype": "bf16",
                                           "overlap_depth": 4,
                                           "overlap_reps": 1})]:
        c = cfg.replace(**knobs)
        b = create_benchmark(name, c, torch.device("cpu"))
        b.setup()
        res = run_benchmark(b, c, verbose=False)
        assert res.validation.passed, (name, res.validation.messages[:3])
        assert (res.overlap_statistics is not None) == (c.overlap_depth > 1)
        assert (res.dawsim_pacer == "native") == c.dawsim

    import contextlib, io, json
    from gpuaudiobench_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--benchmark", "IIRFilter", "--nTracks", "8",
                       "--bufferSize", "64", "--nRuns", "2", "--json"],
                      device="cpu")
    lines = buf.getvalue().splitlines()
    assert rc == 0, lines[-10:]
    rec = json.loads("\\n".join(lines[lines.index("{"):-1]))
    assert rec["validation"]["status"] == "SUCCESS"
    import os, tempfile
    tmp = tempfile.mkdtemp()
    csv = os.path.join(tmp, "r.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--benchmark", "DAWSessionMix", "--nTracks", "8",
                       "--bufferSize", "64", "--irLength", "300", "--nRuns",
                       "2", "--outputfile", csv, "--latenciesFile",
                       os.path.join(tmp, "lat.txt")], device="cpu")
    assert rc == 0
    assert open(csv).read().startswith("benchmark,fs,bufferSize")
    import shutil
    shutil.rmtree(tmp)
    from gpuaudiobench_tpu_torch.tools import capacity, soak
    from gpuaudiobench_tpu_torch.webui import server
    tmp = tempfile.mkdtemp()
    with contextlib.redirect_stdout(io.StringIO()):
        assert soak.main(["1", os.path.join(tmp, "s.md"), "gain", "8",
                          "--set", "fs=4096", "--checkpoint",
                          os.path.join(tmp, "s.npz"), "--device", "cpu"]) == 0
        assert capacity.main(["--benchmark", "gain", "--device", "cpu",
                              "--confirmOnly", "8", "--nRuns", "1",
                              "--pipelineDepth", "4", "--satReps", "2",
                              "--bufferSize", "64", "--fs", "1000"]) == 0
    httpd = server.serve(port=0, presets_path=os.path.join(tmp, "p.json"),
                         device="cpu")
    httpd.job_runner.shutdown()
    httpd.server_close()
    shutil.rmtree(tmp)
    from gpuaudiobench_tpu_torch.ops import modal as tops
    tabs = [torch.rand(960) for _ in range(5)]
    out, _, _ = tops.modal_bank(*tabs, 16, 12, algorithm="res")
    assert out.shape == (12, 16)
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("OK", len(names))
""")


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", BLOCKED_JAX], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.split()[-2] == "OK" and int(r.stdout.split()[-1]) >= 96


def _periodic_step(period):
    """A stream body whose carry holds a Python int that advances one a
    block modulo ``period`` (PartConv's ring head, the nupols phase)."""
    def step(carry):
        x, head = carry
        return (x * 0.5, (head + 1) % period), x.sum().reshape(1)
    return step


def _second(step, carry, blocks=94):
    for _ in range(blocks):
        carry, _ = step(carry)
    return carry


class _RefusingChain:
    """Stands in for ``ChainGraph`` on the CPU: raises ``AdvancingCarry``
    from ``check_continues`` over one eager second, as the real graph's
    warm-up does before it captures, and otherwise records that a graph
    was built."""

    built = []

    def __init__(self, step_fn, carry, depth, name="", continuing=False):
        from gpuaudiobench_tpu_torch.harness import graph

        assert continuing
        graph.check_continues(
            carry, _second(step_fn, graph.clone_carry(carry), depth), depth,
            name)
        self.built.append(name)


@pytest.mark.parametrize("period", [8, 3, 95])
def test_soak_never_replays_a_graph_over_advancing_python_values(
        period, monkeypatch):
    """A second whose carry's Python values come back other than they
    went in makes the continuing graph refuse before it captures, and the
    soak runs the loop on a CUDA device too, from the caller's carry."""
    from gpuaudiobench_tpu_torch.harness import graph
    from gpuaudiobench_tpu_torch.tools import soak

    step, carry = _periodic_step(period), (torch.ones(4), 0)
    with pytest.raises(graph.AdvancingCarry, match="Python values"):
        graph.check_continues(carry, _second(step, carry), 94)
    _RefusingChain.built = []
    monkeypatch.setattr(soak, "ChainGraph", _RefusingChain)
    sec = soak.Seconds(step, carry, 94, torch.device("cuda"),
                       capturable=True)
    assert sec.advancing and sec.form == "loop" and sec._graph is None
    assert _RefusingChain.built == []
    # It runs the loop, carrying the int from call to call.
    sec.run()
    assert sec.carry()[1] == 94 % period


@pytest.mark.parametrize("period", [1, 2, 47, 94])
def test_soak_takes_the_graph_where_the_values_come_back(period,
                                                         monkeypatch):
    """A period dividing the second's 94 blocks leaves the values as they
    came: on a CUDA device the soak builds the continuing graph (the real
    ``ChainGraph`` refuses CPU tensors); the CPU runs the loop."""
    from gpuaudiobench_tpu_torch.harness import graph
    from gpuaudiobench_tpu_torch.tools import soak

    step, carry = _periodic_step(period), (torch.ones(4), 0)
    graph.check_continues(carry, _second(step, carry), 94)
    with pytest.raises(ValueError, match="one CUDA device"):
        soak.Seconds(step, carry, 94, torch.device("cuda"), capturable=True)
    _RefusingChain.built = []
    monkeypatch.setattr(soak, "ChainGraph", _RefusingChain)
    sec = soak.Seconds(step, carry, 94, torch.device("cuda"), name="toy")
    assert sec.form == "cuda-graph" and sec.advancing is False
    assert _RefusingChain.built == ["toy"]
    for dev, capturable in ((CPU, True), (torch.device("cuda"), False)):
        sec = soak.Seconds(step, carry, 94, dev, capturable=capturable)
        assert sec.advancing is None and sec.form == "loop"


@pytest.mark.parametrize("form,advancing", [("ring", False),
                                            ("nupols", True)])
def test_partconv_python_values_over_a_second(form, advancing):
    """At 48,000 taps the ring head's period is 94 partitions, one
    second of 512-sample blocks; the nupols phase's is K = 8."""
    from gpuaudiobench_tpu_torch.harness import graph
    from gpuaudiobench_tpu_torch.tools import soak

    cfg = BenchConfig(n_tracks=1, ir_length=48000, partconv_form=form,
                      verification="none", device_timing=False)
    b = registry.create_benchmark("PartConv", cfg, CPU)
    b.setup()
    step, carry = b.stream_body()
    exit_ = _second(step, graph.clone_carry(carry))
    if advancing:
        with pytest.raises(graph.AdvancingCarry):
            graph.check_continues(carry, exit_, 94, "PartConv")
    else:
        graph.check_continues(carry, exit_, 94, "PartConv")
    assert soak.Seconds(step, carry, 94, CPU).form == "loop"


def test_no_source_mentions_jax():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert not any(
                    w.split(".")[0] in ("jax", "jaxlib", "gpuaudiobench_tpu")
                    for w in words[1:2]), f"{f}: {line}"
    # The package's C++ sources (the native driver embeds CPython): no
    # jax, and no module of the JAX package by its dotted name.
    sources = sorted((PKG / "csrc").glob("*.cc"))
    assert {f.name for f in sources} >= {"gpubench_main.cc",
                                         "gpuab_native.cc"}
    for f in sources:
        for line in f.read_text().splitlines():
            assert not re.search(r"\bjax(lib)?\b|\bgpuaudiobench_tpu\.",
                                 line, re.IGNORECASE), f"{f}: {line}"


@pytest.fixture
def port_cfg(small_cfg):
    return BenchConfig(**{f.name: getattr(small_cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_stage_pinned_never_returns_a_pageable_tensor(monkeypatch):
    """Where the allocator hands back memory that is not page-locked,
    ``stage_pinned`` on a CUDA device raises rather than return it."""
    real_empty = torch.empty

    def pageable_empty(*args, pin_memory=False, **kw):
        return real_empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", pageable_empty)
    with pytest.raises(RuntimeError, match="not page-locked"):
        dev.stage_pinned(np.zeros(8, np.float32), torch.device("cuda:0"))


def test_device_cuda_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="is_available"):
        dev.device("cuda")


def test_bench_main_cuda_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(n_tracks=8, n_runs=1, warmup=0, pipeline_depth=0,
                   device="cuda")


def _tables(m=256, dtype=torch.float32):
    return [torch.ones(m, dtype=dtype) for _ in range(5)]


@pytest.mark.parametrize("fn", ["modal_bank", "modal_folded_step"])
def test_wrappers_reject_bad_input(fn):
    wrapper = getattr(tops, fn)
    n = 5 if fn == "modal_bank" else 4
    with pytest.raises(TypeError, match="float32"):
        wrapper(*_tables(dtype=torch.float64)[:n], 32, 32)
    strided = [torch.ones(512)[::2] for _ in range(n)]
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*strided, 32, 32)
    uneven = _tables()[:n - 1] + [torch.ones(128)]
    with pytest.raises(ValueError, match="equal-length"):
        wrapper(*uneven, 32, 32)
    with pytest.raises(ValueError, match="multiple of output_tracks"):
        wrapper(*_tables(m=100)[:n], 32, 32)


@pytest.mark.parametrize("fn", ["modal_bank", "modal_folded_step"])
def test_wrappers_raise_on_a_device_without_a_kernel(fn):
    """Only a CPU tensor takes the plain twin; any other device gets the
    kernel or an error, never the twin."""
    n = 5 if fn == "modal_bank" else 4
    meta = [torch.empty(256, device="meta") for _ in range(n)]
    with pytest.raises(ValueError, match="no kernel"):
        getattr(tops, fn)(*meta, 32, 32)


class _FailingWarmup(Benchmark):
    name = "FailingWarmup"

    def iterate(self):
        raise RuntimeError("iteration failed")


def test_runner_propagates_warmup_exception(port_cfg):
    b = _FailingWarmup(port_cfg, CPU)
    with pytest.raises(RuntimeError, match="iteration failed"):
        run_benchmark(b, port_cfg, verbose=False)


def test_registry_names_mirror_the_reference():
    assert registry.BENCHMARK_NAMES == jax_registry.BENCHMARK_NAMES
    assert registry.EXTENSION_NAMES == jax_registry.EXTENSION_NAMES
    assert registry.list_benchmarks() == jax_registry.list_benchmarks()


@pytest.mark.parametrize("name", ["MultiChipSuite", "ICIBandwidth"])
def test_unported_benchmarks_raise(port_cfg, name, monkeypatch):
    """Every name has a factory now (the last two, ported by queue 1,
    item 18a, are the cases): a name listed in UNPORTED_BENCHMARKS and
    without a factory raises naming its item."""
    assert name in registry.ported_benchmarks()
    factories = registry._factories()
    del factories[name]
    monkeypatch.setattr(registry, "_factories", lambda: factories)
    monkeypatch.setitem(registry.UNPORTED_BENCHMARKS, name,
                        "queue 1, item 18a")
    with pytest.raises(NotImplementedError,
                       match="not yet ported; see ROADMAP.md queue 1, "
                             "item 18a"):
        registry.create_benchmark(name, port_cfg, CPU)


def test_unported_names_are_exactly_those_without_a_factory():
    assert set(registry.UNPORTED_BENCHMARKS) == (
        set(registry.list_benchmarks()) - set(registry.ported_benchmarks()))
    assert len(registry.ported_benchmarks()) == 30
    assert registry.CATEGORIES == jax_registry.CATEGORIES


def test_unknown_benchmark_raises(port_cfg):
    with pytest.raises(KeyError):
        registry.create_benchmark("NoSuchBenchmark", port_cfg, CPU)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("name", ["IIRFilter", "BiquadChain", "RndMemRead",
                                  "DWG1DNaive", "DWG1DAccel", "FDTD3D"])
def test_iir_models_refuse_impl_xla_on_cuda(port_cfg, name):
    """On a CUDA device the IIR models (and the other kernel benchmarks)
    run only the kernels: impl xla (the plain twin) raises. A device
    descriptor needs no GPU."""
    with pytest.raises(ValueError, match="xla"):
        registry.create_benchmark(name, port_cfg.replace(impl="xla"),
                                  torch.device("cuda:0"))


@pytest.mark.parametrize("kind", ["iir_biquad", "iir_biquad_blockstate",
                                  "iir_cascade", "iir_cascade_chain"])
def test_iir_wrappers_raise_on_a_device_without_a_kernel(kind):
    """Only a CPU tensor takes the plain twin; any other device gets the
    kernel or an error."""
    from gpuaudiobench_tpu_torch.ops import iir as iops

    x = torch.empty((8, 64), device="meta")
    if kind.startswith("iir_cascade"):
        args = (x, torch.empty((3, 5), device="meta"),
                torch.empty((3, 8, 2), device="meta"))
    elif kind == "iir_biquad":
        args = (x, torch.empty(5, device="meta"),
                torch.empty((8, 2), device="meta"))
    else:
        args = (x, torch.empty(5, device="meta"),
                torch.empty((16, 16), device="meta"),
                torch.empty((16, 2), device="meta"),
                torch.empty((8, 2), device="meta"))
    launches = dict(iops.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="no kernel"):
        getattr(iops, kind)(*args)
    assert iops.KERNEL_LAUNCHES == launches


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_chip_smoke_bounds():
    """The bounds of the kernels line: bytes over 3.35 TB/s against FP32
    FLOP over 67 TFLOP/s, at the main shapes."""
    cs = _chip_smoke()
    ms, by = cs.modal_bound()
    m, s, t = cs.MAIN_SHAPE
    assert by == "operations" and ms == pytest.approx(7 * m * s / 67e9)
    ms, by = cs.res_bound()
    assert by == "operations" and ms == pytest.approx(5 * m * s / 67e9)
    ms, by = cs.conv_bound()
    tracks, s_conv, l = cs.CONV_FULL
    assert (tracks, s_conv, l) == (19456, 512, 1024)
    assert by == "operations"
    assert ms == pytest.approx(2 * tracks * s_conv * l / 67e9)
    assert ms == pytest.approx(0.304, abs=1e-3)  # against 0.048 ms of bytes
    bounds = cs.iir_bounds(128)
    tracks, s = cs.IIR_FULL
    io_ms = 8 * tracks * s / 3.35e9
    assert set(bounds) == set(cs.IIR_REPLACES)
    for name, (b_ms, b_by) in bounds.items():
        assert b_by == "bytes" and io_ms < b_ms < 1.05 * io_ms, name
    # the triangular blockstate product: 138 FLOP a sample at m = 128,
    # under the bytes; dense (265 FLOP) it would be operations-bound.
    assert (128 + 10) * tracks * s / 67e9 < io_ms < 265 * tracks * s / 67e9
    # the slice's kernels: RndMem 2 x T x S x 4 B; DWG 16 B a touched cell
    # pair; FDTD at room 50 (52^3 cells, 50^3 interior, 1,536 substeps):
    # 11 FLOP an interior cell for div, 3 a face and 7 an interior cell for
    # field, 1 a boundary cell.
    tracks, s, _ = cs.RNDMEM_FULL
    ms, by = cs.rndmem_bound()
    assert by == "bytes" and ms == pytest.approx(
        (8 * tracks * s + 4 * tracks) / 3.35e9)
    g, s, _ = cs.DWG_FULL
    ms, by = cs.dwg_bound(g * s)
    assert by == "bytes" and ms == pytest.approx(
        (16 * g * s + 8 * s + 24 * g) / 3.35e9)
    bounds = cs.fdtd_bounds()
    edge = 52 ** 3 - 50 ** 3
    small = 2 * 128 * 512 + 2 * 512
    div_ms, by = bounds["fdtd3d_div"]
    assert by == "operations"
    assert div_ms == pytest.approx(
        (1536 * (11 * 50 ** 3 + edge) + small) / 67e9)
    assert div_ms == pytest.approx(0.0319, abs=1e-4)
    field_ms, by = bounds["fdtd3d_field"]
    assert by == "operations"
    assert field_ms == pytest.approx(
        (1536 * (9 * 51 * 52 ** 2 + 7 * 50 ** 3 + edge) + small) / 67e9)
    assert field_ms == pytest.approx(0.0489, abs=1e-4)
    # the cooperative divergence kernel where it is timed: room 82 (84^3
    # cells), and the field kernel there too, under its own key
    edge = 84 ** 3 - 82 ** 3
    div_ms, by = bounds["fdtd3d_div_coop"]
    assert by == "operations" and div_ms == pytest.approx(
        (1536 * (11 * 82 ** 3 + edge) + small) / 67e9)
    field_ms, by = bounds[cs.FDTD_FIELD_82_KEY]
    assert by == "operations" and field_ms == pytest.approx(
        (1536 * (9 * 83 * 84 ** 2 + 7 * 82 ** 3 + edge) + small) / 67e9)
    assert field_ms == pytest.approx(0.2103, abs=1e-4)
    # and at room 128 (130^3 cells), the largest room the config allows,
    # printed beside its time under its own key
    assert cs.FDTD_BIG == (128, 512, 128)
    edge = 130 ** 3 - 128 ** 3
    div_ms, by = bounds[cs.FDTD_BIG_KEY]
    assert by == "operations" and div_ms == pytest.approx(
        (1536 * (11 * 128 ** 3 + edge) + small) / 67e9)
    assert div_ms == pytest.approx(0.5311, abs=1e-4)
    # the FMA kernels at their defaults: 2 FLOP an element and pass
    bounds = cs.sol_bounds()
    for name, (rows, width, k) in (("fma_chain", cs.SOL_FMA_FULL),
                                   ("fma_vmem", cs.SOL_VMEM_FULL)):
        ms, by = bounds[name]
        assert by == "operations" and ms == pytest.approx(
            2 * k * rows * width / 67e9)
    assert bounds["fma_chain"][0] == pytest.approx(0.0321, abs=1e-4)
    assert bounds["fma_vmem"][0] == pytest.approx(0.0080, abs=1e-4)


def test_chip_smoke_bounds_read_the_cost_models():
    """One count: the kernels line's RndMem, DWG and FDTD bounds are the
    benchmarks' own cost models at the main shapes."""
    from gpuaudiobench_tpu_torch.models.dwg import dwg_cost
    from gpuaudiobench_tpu_torch.models.fdtd3d import fdtd3d_cost
    from gpuaudiobench_tpu_torch.models.rndmem import rndmem_cost

    cs = _chip_smoke()
    tracks, s, _ = cs.RNDMEM_FULL
    assert cs.rndmem_bound() == cs.cost_bound(rndmem_cost(tracks, s))
    g, s, _ = cs.DWG_FULL
    assert cs.dwg_bound(12345) == cs.cost_bound(dwg_cost(g, s, 12345))
    for shape, names in ((cs.FDTD_MAIN, ("fdtd3d_div", "fdtd3d_field")),
                         (cs.FDTD_COOP, ("fdtd3d_div_coop",
                                         cs.FDTD_FIELD_82_KEY)),
                         (cs.FDTD_BIG, (cs.FDTD_BIG_KEY,))):
        room, s, tracks = shape
        for name, per_track in zip(names, (False, True)):
            assert cs.fdtd_bounds()[name] == cs.cost_bound(
                fdtd3d_cost(room, s, tracks, per_track))


@pytest.mark.parametrize("fn", ["fma_chain", "fma_vmem"])
def test_sol_wrappers_reject_bad_input(fn):
    from gpuaudiobench_tpu_torch.ops import speedoflight as sops

    wrapper = getattr(sops, fn)
    with pytest.raises(TypeError, match="float32"):
        wrapper(torch.ones((4, 8), dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="2-D"):
        wrapper(torch.ones(8), 3)
    with pytest.raises(ValueError, match="2-D"):
        wrapper(torch.ones((0, 8)), 3)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(torch.ones((8, 4)).t(), 3)
    for k in (-1, 2.0, True):
        with pytest.raises(ValueError, match="k must be"):
            wrapper(torch.ones((4, 8)), k)


@pytest.mark.parametrize("fn", ["fma_chain", "fma_vmem"])
def test_sol_wrappers_raise_on_a_device_without_a_kernel(fn):
    from gpuaudiobench_tpu_torch.ops import speedoflight as sops

    launches = dict(sops.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="no kernel"):
        getattr(sops, fn)(torch.empty((4, 8), device="meta"), 3)
    assert sops.KERNEL_LAUNCHES == launches


def _slice_ops():
    from gpuaudiobench_tpu_torch.ops import conv as cops
    from gpuaudiobench_tpu_torch.ops import dwg as dops
    from gpuaudiobench_tpu_torch.ops import fdtd3d as fops
    from gpuaudiobench_tpu_torch.ops import iir as iops
    from gpuaudiobench_tpu_torch.ops import rndmem as rops
    from gpuaudiobench_tpu_torch.ops import speedoflight as sops

    return {"modal": tops, "iir": iops, "conv": cops, "rndmem": rops,
            "dwg": dops, "fdtd": fops, "sol": sops}


def test_chip_smoke_counts_twin_calls_and_restores_them():
    cs = _chip_smoke()
    mods = _slice_ops()
    iops, cops, rops = mods["iir"], mods["conv"], mods["rndmem"]
    dops, fops = mods["dwg"], mods["fdtd"]
    originals = {(k, n): getattr(mods[k], n)
                 for k, names in cs.TwinCalls.NAMES.items() for n in names}
    x = torch.zeros((4, 8))
    with cs.TwinCalls(mods) as twins:
        iops.iir_cascade(x, torch.zeros((2, 5)), torch.zeros((2, 4, 2)))
        cops.conv1d_direct(x, torch.zeros((4, 3)), "bleed")
        eps, y, q = (torch.zeros(64) for _ in range(3))
        tops.modal_res_step(eps, y, q, 4, 8)
        rops.rndmem_gather(torch.zeros(64), torch.zeros(2, dtype=torch.int32),
                           8)
        g = 2
        ints = [torch.full((g,), 4, dtype=torch.int32) for _ in range(3)]
        dops.dwg_block(torch.zeros(4), torch.zeros((g, 4)),
                       torch.zeros((g, 4)), *ints,
                       *[torch.ones(g) for _ in range(3)])
        fops.fdtd3d_block_div(torch.zeros((1, 2)),
                              *fops.zero_fields_div(5), (2, 2, 2), (1, 2, 3))
        fops.fdtd3d_block_field(torch.zeros((1, 2)), *fops.zero_fields(5),
                                (2, 2, 2), (1, 2, 3))
        mods["sol"].fma_vmem(torch.zeros((2, 3)), 2)
    # the cascade twin and its 2 stages, conv, res, rndmem, dwg, 2 fdtd,
    # the FMA chain
    assert twins.calls == 10
    assert {k: getattr(mods[k[0]], k[1]) for k in originals} == originals
    iops.KERNEL_LAUNCHES["iir_biquad"] += 1
    cops.KERNEL_LAUNCHES["conv1d"] += 1
    tops.KERNEL_LAUNCHES["modal_res"] += 1
    fops.KERNEL_LAUNCHES["fdtd3d_div"] += 1
    modules = list(mods.values())
    # A kernel's launches add its chain graphs' replayed ones.
    from gpuaudiobench_tpu_torch.harness import graph

    graph.REPLAYED_LAUNCHES["conv1d"] += 5
    graph.CHAIN_REPLAYS["chain"] += 1
    assert cs.launch_counts(*modules)["conv1d"] == (
        cops.KERNEL_LAUNCHES["conv1d"] + 5)
    cs.reset_counts(*modules)
    assert graph.REPLAYED_LAUNCHES.get("conv1d", 0) == 0
    assert graph.CHAIN_REPLAYS["chain"] == 0
    counts = cs.launch_counts(*modules)
    assert set(counts) == {"modal_bank", "modal_res", "conv1d",
                           "rndmem_gather", "dwg_block", "fdtd3d_div",
                           "fdtd3d_field", "fdtd3d_receiver_buckets",
                           "fdtd3d_div_coop", "fma_chain", "fma_vmem",
                           *iops.KERNEL_LAUNCHES}
    assert not any(counts.values())


def test_chip_smoke_lists_every_twin_and_kernel():
    """Every plain twin of a ported kernel is counted on the main paths,
    and the kernels line has a row for each of the 15 kernels (the 13
    ported ones, the FDTD divergence form on two routes, and the kernel
    that buckets the field form's per-track receivers)."""
    cs = _chip_smoke()
    mods = _slice_ops()
    assert set(mods) == set(cs.TwinCalls.NAMES)
    kernels = set()
    for key, mod in mods.items():
        twins = {n for n in dir(mod)
                 if n.endswith("_plain") and callable(getattr(mod, n))}
        assert twins == set(cs.TwinCalls.NAMES[key]), key
        kernels |= set(mod.KERNEL_LAUNCHES)
    text = (REPO / "chip_smoke.py").read_text()
    for name in kernels:
        assert f'"{name}"' in text, name
    assert len(kernels) == 15
    assert set(cs.FDTD_REPLACES) == {"fdtd3d_div", "fdtd3d_field",
                                     "fdtd3d_receiver_buckets",
                                     "fdtd3d_div_coop"}
    assert set(cs.SOL_REPLACES) == {"fma_chain", "fma_vmem"}
    for replaces in (cs.RNDMEM_REPLACES, cs.DWG_REPLACES,
                     *cs.FDTD_REPLACES.values(), *cs.SOL_REPLACES.values()):
        path, line = replaces.split(":")
        src = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert src.startswith("def _") and "kernel" in src, replaces


def _device_functions(src):
    """{name: body} of every ``__global__`` and ``__device__`` function of
    a CUDA source (templates included), found by brace matching."""
    import re

    src = re.sub(r"__launch_bounds__\([^)]*\)", "", src)
    out = {}
    for m in re.finditer(
            r"__(?:global|device)__\s[^;{]*?\b(\w+)\s*\([^;{]*?\)\s*(?:const\s*)?\{",
            src):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        out.setdefault(m.group(1), "")
        out[m.group(1)] += src[m.end():i]
    return out


def _reached(funcs, root):
    """The device functions ``root`` calls, transitively."""
    import re

    seen, todo = set(), [root]
    while todo:
        body = funcs[todo.pop()]
        for name in funcs:
            if name not in seen and re.search(rf"\b{name}\s*(<[^;]*?>)?\s*\(", body):
                seen.add(name)
                todo.append(name)
    return seen - {root}


@pytest.mark.parametrize("kernel,other", [
    ("iir_cascade_chain_kernel", "iir_cascade_systolic_kernel"),
    ("iir_cascade_systolic_kernel", "iir_cascade_chain_kernel")])
def test_cascade_kernels_share_no_device_code(kernel, other):
    """The chain cascade is the systolic cascade's oracle: neither kernel
    calls a device function the other reaches, nor the other kernel."""
    src = (PKG / "csrc" / "iir.cu").read_text()
    funcs = _device_functions(src)
    assert {kernel, other, "ch_samples", "cascade_step"} <= set(funcs)
    mine, theirs = _reached(funcs, kernel), _reached(funcs, other)
    assert mine and theirs
    assert other not in mine
    assert not mine & (theirs | {other}), sorted(mine & theirs)
