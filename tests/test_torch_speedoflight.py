"""The speed-of-light slice of the PyTorch port against the JAX package, on
the CPU at small sizes: the FMA twin against the JAX chain (XLA, and both
Pallas kernels in interpret mode), the six SOL benchmarks against the JAX
benchmarks, the roofline accounting against ``utils/roofline.py``, the
runner's roofline section, the restored cost models, the calibration's
refusals and the ``--sol*`` flags.

Tolerances: the twin rounds twice a pass (a multiply, then an add) where
the JAX chain may round once; values stay O(1) and k <= 130, so the two
differ by at most k * 2^-23 * 2 < 1e-5. Against the closed form the
benchmarks' 5e-4 holds.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu import cli as jax_cli
from gpuaudiobench_tpu import registry as jax_registry
from gpuaudiobench_tpu.harness.runner import run_benchmark as jax_run
from gpuaudiobench_tpu.ops import speedoflight as jax_sol
from gpuaudiobench_tpu.utils import roofline as jax_roofline
from gpuaudiobench_tpu_torch import calibrate_peaks, cli, registry
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import runner
from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
from gpuaudiobench_tpu_torch.ops import speedoflight as sol
from gpuaudiobench_tpu_torch.utils import roofline

CPU = torch.device("cpu")
SOL_NAMES = ["SOL_VPU", "SOL_VMEM", "SOL_HBM", "SOL_MXU_bf16", "SOL_MXU_f32",
             "SOL_MXU_int8"]
TWIN_ATOL = 1e-5
GOLDEN_ATOL = 5e-4
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def jax_cfg(small_cfg):
    return small_cfg.replace(fdtd_room=8)


@pytest.fixture
def port_cfg(jax_cfg):
    return BenchConfig(**{f.name: getattr(jax_cfg, f.name)
                          for f in dataclasses.fields(BenchConfig)})


def _x(rows, width=1024, seed=3):
    g = np.random.Generator(np.random.MT19937(seed + rows))
    return (g.random((rows, width), dtype=np.float32) * 2 - 1).astype(np.float32)


def _jax_fn(kind):
    if kind == "xla":
        return jax_sol.fma_chain_xla, contextlib.nullcontext
    from jax.experimental.pallas import tpu as pltpu

    fn = (jax_sol.fma_chain_pallas if kind == "pallas-chain"
          else jax_sol.fma_vmem_pallas)
    return fn, pltpu.force_tpu_interpret_mode


@pytest.mark.parametrize("kind", ["xla", "pallas-chain", "pallas-vmem"])
@pytest.mark.parametrize("rows", [16, 13])
@pytest.mark.parametrize("k", [0, 1, 24, 130])
def test_twin_matches_the_jax_chain(kind, rows, k):
    """Rows that are (16) and are not (13) multiples of 8: at 13 the JAX
    wrappers take their XLA fallback, as on the TPU."""
    x = _x(rows)
    fn, mode = _jax_fn(kind)
    with mode():
        want = np.asarray(fn(x, k))
    got = sol.fma_chain_plain(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TWIN_ATOL)
    np.testing.assert_allclose(got, sol.fma_golden(x, k), rtol=0,
                               atol=GOLDEN_ATOL)


@pytest.mark.parametrize("name", ["fma_chain", "fma_vmem"])
@pytest.mark.parametrize("shape,k", [((37, 1000), 24), ((64, 1024), 130),
                                     ((3, 5), 0)])
def test_wrappers_on_cpu_are_the_twin(name, shape, k):
    x = torch.from_numpy(_x(shape[0], shape[1]))
    launches = dict(sol.KERNEL_LAUNCHES)
    got = getattr(sol, name)(x, k)
    assert sol.KERNEL_LAUNCHES == launches  # the twin, no kernel
    assert got is not x and torch.equal(got, sol.fma_chain_plain(x, k))


def test_golden_and_constants_are_the_reference():
    assert (sol.FMA_M, sol.FMA_C) == (jax_sol.FMA_M, jax_sol.FMA_C)
    x = _x(8)
    for k in (0, 7, 512):
        np.testing.assert_array_equal(sol.fma_golden(x, k),
                                      jax_sol.fma_golden(x, k))


def test_matmul_ops_on_cpu():
    g = np.random.Generator(np.random.MT19937(1))
    a = torch.from_numpy(g.random((32, 16), dtype=np.float32))
    b = torch.from_numpy(g.random((16, 24), dtype=np.float32))
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = sol.matmul_bf16(ab, bb)
    assert out.dtype == torch.float32
    assert torch.equal(out, ab.float() @ bb.float())
    assert torch.equal(sol.matmul_f32(a, b), a @ b)
    ai = torch.from_numpy(g.integers(-127, 128, (32, 16)).astype(np.int8))
    bi = torch.from_numpy(g.integers(-127, 128, (16, 24)).astype(np.int8))
    want = ai.numpy().astype(np.int64) @ bi.numpy().astype(np.int64)
    got = sol.matmul_int8(ai, bi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sol.stream_scale(a), a * 2)


@pytest.mark.parametrize("shapes", [((16, 16), (16, 8)), ((32, 12), (12, 8)),
                                    ((32, 16), (16, 12))])
def test_matmul_int8_refuses_what_the_card_does_not_take(shapes):
    a = torch.zeros(shapes[0], dtype=torch.int8)
    b = torch.zeros(shapes[1], dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        sol.matmul_int8(a, b)


def test_matmul_f32_refuses_tf32():
    a = torch.ones((4, 4))
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            sol.matmul_f32(a, a)
    finally:
        torch.set_float32_matmul_precision("highest")


# --- the six benchmarks against the JAX package's ---------------------


@pytest.mark.parametrize("name", SOL_NAMES)
def test_sol_benchmark_matches_the_reference(jax_cfg, port_cfg, name):
    ours = registry.create_benchmark(name, port_cfg, CPU)
    ours.setup()
    result = run_benchmark(ours, port_cfg.replace(pipeline_depth=4,
                                                  saturated_reps=2),
                           verbose=False)
    assert result.validation.passed, result.validation.messages[:3]
    assert "roofline" not in result.metadata  # a CPU run
    ref = jax_registry.create_benchmark(name, jax_cfg)
    ref.setup()
    assert jax_run(ref, jax_cfg, verbose=False).validation.passed
    np.testing.assert_allclose(np.asarray(ours.golden, np.float64),
                               np.asarray(ref.golden, np.float64),
                               rtol=1e-6, atol=0)
    if name.startswith("SOL_MXU"):
        np.testing.assert_array_equal(
            ours.host_a.float().numpy(),
            np.asarray(ref.host_a).astype(np.float32))
        if name == "SOL_MXU_int8":
            np.testing.assert_array_equal(ours.golden, ref.golden)
    else:
        np.testing.assert_array_equal(ours.host_input, ref.host_input)
    assert ours.transfer_model() == ref.transfer_model()
    assert ours.tolerance == ref.tolerance
    mine, theirs = ours.cost_model(), ref.cost_model()
    if name == "SOL_VMEM":  # the CPU note names the port's twin
        mine.pop("note"), theirs.pop("note")
    assert mine == theirs


def test_sol_vmem_declares_vmem_bytes(port_cfg):
    bench = registry.create_benchmark("SOL_VMEM", port_cfg, CPU)
    bench.setup()
    cost = bench.cost_model()
    assert cost["vmem_bytes"] == bench.k * 8 * bench.host_input.size
    rl = roofline.roofline_metrics(cost, 1.0)
    assert rl["vmem_pct_of_peak"] > 0 and "achieved_vmem_gbps" in rl
    assert bench.metadata()["impl"] == "torch-plain"


def test_matmul_f32_meets_full_fp32(port_cfg):
    """The port's f32 GEMM is full FP32 (TF32 off), the counterpart of the
    reference's HIGHEST check: max error < 1e-4 at the test size."""
    bench = registry.create_benchmark("SOL_MXU_f32", port_cfg, CPU)
    bench.setup()
    v = bench.validate()
    assert v.passed and v.max_error < 1e-4
    assert bench.metadata()["matmulPrecision"] == "highest"


# --- roofline accounting against the reference ------------------------


def test_roofline_tables_match_the_reference():
    assert set(roofline.SPEC_PEAK) == set(jax_roofline.SPEC_PEAK)
    assert roofline.UNIT_PEAK_KEY == jax_roofline.UNIT_PEAK_KEY
    assert (roofline.LATENCY_BOUND_THRESHOLD_PCT
            == jax_roofline.LATENCY_BOUND_THRESHOLD_PCT)
    assert {k for k, _ in calibrate_peaks.TARGETS.values()} == set(
        roofline.SPEC_PEAK)
    # the H100 SXM data sheet at 700 W, not a TPU's
    assert roofline.SPEC_PEAK["hbm_bytes_per_sec"] == 3.35e12
    assert roofline.SPEC_PEAK["mxu_bf16_flops"] == 989e12
    assert roofline.SPEC_PEAK["vmem_bytes_per_sec"] == pytest.approx(33.4e12,
                                                                     rel=2e-3)


def _peaks_file(tmp_path, kind, peaks, stamp="2026-10-17"):
    path = tmp_path / "peaks.json"
    path.write_text(json.dumps({"device_kind": kind, "measured_at": stamp,
                                "peaks": peaks}))
    return str(path)


COSTS = [
    {"flops": 2e9, "hbm_bytes": 1e6, "unit": "vpu", "note": "n"},
    {"flops": 0, "hbm_bytes": 3e9, "unit": "vpu"},
    {"flops": 1e12, "hbm_bytes": 2e8, "unit": "mxu_bf16"},
    {"flops": 4e8, "hbm_bytes": 8e6, "vmem_bytes": 3e10, "unit": "vpu"},
    {"flops": 5e6, "hbm_bytes": 5e6, "unit": "none"},
]
FILES = {
    "spec": (None, None),
    "matching": (H100, {"vpu_f32_flops": 5e13, "hbm_bytes_per_sec": 3e12,
                        "vmem_bytes_per_sec": 2e13, "mxu_bf16_flops": 6e14,
                        "mxu_f32_flops": 5e13, "mxu_int8_flops": 1e15}),
    "mismatched": ("NVIDIA H200", {"vpu_f32_flops": 5e13}),
    "partial": (H100, {"vpu_f32_flops": 5e13, "hbm_bytes_per_sec": 3e12}),
}


@pytest.mark.parametrize("case", sorted(FILES))
@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("device_ms", [0.0, 0.05, 3.0])
def test_roofline_metrics_match_the_reference(monkeypatch, tmp_path, case,
                                              cost, device_ms):
    kind, peaks = FILES[case]
    path = (str(tmp_path / "absent.json") if peaks is None
            else _peaks_file(tmp_path, kind, peaks))
    for mod in (roofline, jax_roofline):
        monkeypatch.setattr(mod, "MEASURED_PEAKS_PATH", path)
        mod._load_measured.cache_clear()
    # The same data-sheet table on both sides: the JAX one is a TPU's.
    monkeypatch.setattr(jax_roofline, "SPEC_PEAK", dict(roofline.SPEC_PEAK))
    try:
        assert roofline.resolve_peaks(H100) == jax_roofline.resolve_peaks(H100)
        assert (roofline.roofline_metrics(cost, device_ms, H100)
                == jax_roofline.roofline_metrics(cost, device_ms, H100))
        src = roofline.resolve_peaks(H100)[1]
        if case == "partial":
            assert src.startswith(f"measured({H100}, 2026-10-17) +spec:")
            assert "mxu_bf16_flops" in src and "vpu_f32_flops" not in src
        else:
            assert src == {"spec": "spec-estimate",
                           "mismatched": "spec-estimate",
                           "matching": f"measured({H100}, 2026-10-17)"}[case]
        assert roofline.resolve_peaks(None)[1] == "spec-estimate"
    finally:
        for mod in (roofline, jax_roofline):
            mod._load_measured.cache_clear()


def test_shipped_calibration_is_the_h100s():
    """The committed peaks were measured on an H100 and hold all six keys,
    so on that card the source names no data-sheet fallback."""
    data = json.loads(open(roofline.MEASURED_PEAKS_PATH).read())
    assert data["device_kind"].startswith("NVIDIA H100")
    assert set(data["peaks"]) == set(roofline.SPEC_PEAK)
    assert data["power_limit"] and data["clocks_max_sm"]
    for key, rate in data["peaks"].items():
        assert 0 < rate <= 1.05 * roofline.SPEC_PEAK[key], key
    roofline._load_measured.cache_clear()
    _, source = roofline.resolve_peaks(data["device_kind"])
    assert source.startswith("measured(") and "+spec:" not in source


# --- the runner's roofline section -------------------------------------


def test_runner_roofline_section_only_on_cuda(port_cfg, monkeypatch):
    cfg = port_cfg.replace(pipeline_depth=8, saturated_reps=2)
    bench = registry.create_benchmark("gain", cfg, CPU)
    bench.setup()
    result = run_benchmark(bench, cfg, verbose=False)
    assert "roofline" not in result.metadata
    assert runner.roofline_section(bench, result) is None
    # The same result as if it came from a card.
    monkeypatch.setattr(bench, "device", torch.device("cuda:0"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    rl = runner.roofline_section(bench, result)
    assert rl["basis"] == "saturated-marginal" or rl["basis"] == "saturated"
    assert rl["peak_source"] and rl["hbm_bytes_per_block"] == (
        bench.cost_model()["hbm_bytes"])
    result.device_statistics = result.saturated_statistics
    result.device_timing_method = "cuda-events"
    assert runner.roofline_section(bench, result)["basis"] == (
        "device:cuda-events")
    result.device_timing_method = "wall"  # a host clock is never a basis
    assert runner.roofline_section(bench, result)["basis"] != "device:wall"


# --- every ported benchmark has a cost model ---------------------------

# Where the port counts otherwise than the reference, and why:
# Conv1D runs the FP32 FMA kernel (or its twin), never a matmul unit;
# DWG moves 16 B a touched cell pair (each fwd and bwd cell read and
# written once) plus its parameters, where the reference counts 32 B;
# RndMemRead also reads its playheads; FDTD3D counts the form that runs
# (div 11 FLOP an interior cell, field ~16) and its own fields, where the
# reference counts 20 FLOP a cell and the field form's bytes for both,
# and its shared-memory floor on the unpadded grid; SOL_VMEM's CPU note
# names the port's twin.
COST_DIVERGENCES = {
    "Conv1D": {"unit"},
    "DWG1DNaive": {"hbm_bytes"},
    "DWG1DAccel": {"hbm_bytes"},
    "RndMemRead": {"hbm_bytes"},
    "FDTD3D": {"flops", "hbm_bytes", "vmem_bytes", "note"},
    "SOL_VMEM": {"note"},
}


@pytest.mark.parametrize("name", registry.ported_benchmarks())
def test_every_ported_benchmark_has_the_reference_cost_model(
        jax_cfg, port_cfg, name):
    ours = registry.create_benchmark(name, port_cfg, CPU)
    ours.setup()
    ref = jax_registry.create_benchmark(name, jax_cfg)
    ref.setup()
    mine, theirs = ours.cost_model(), ref.cost_model()
    assert mine is not None and mine["hbm_bytes"] > 0
    assert set(mine) == set(theirs)
    assert mine["unit"] in roofline.UNIT_PEAK_KEY
    differ = {k for k in mine if mine[k] != theirs[k]}
    assert differ == COST_DIVERGENCES.get(name, set()), differ
    assert ours.transfer_model() == ref.transfer_model()


@pytest.mark.parametrize("per_track", [False, True])
def test_fdtd_cost_counts_the_form_that_runs(port_cfg, per_track):
    from gpuaudiobench_tpu_torch.models.fdtd3d import fdtd3d_cost

    room, s, t = 8, 64, 8
    n = room + 2
    cells, faces, interior = n ** 3, (n + 1) * n * n, (n - 2) ** 3
    cost = fdtd3d_cost(room, s, t, per_track)
    if per_track:
        per_cell = 9 * (n - 1) * n * n + 7 * interior
        state = cells + 3 * faces
    else:
        per_cell = 11 * interior
        state = 2 * cells
    assert cost["flops"] == 3 * s * (per_cell + cells - interior) + (
        2 * t * s + 2 * s)
    assert cost["vmem_bytes"] == 3 * s * state * 8
    bench = registry.create_benchmark(
        "FDTD3D", port_cfg.replace(fdtd_per_track_receivers=per_track), CPU)
    assert bench.cost_model() == fdtd3d_cost(room, 64, 8, per_track)


def test_dwg_cost_counts_the_touched_cells(port_cfg):
    bench = registry.create_benchmark("DWG1DNaive", port_cfg, CPU)
    bench.setup()
    touched = int(np.minimum(bench.lengths, 64).sum())
    assert bench.cost_model()["hbm_bytes"] == 16 * touched + 8 * 64 + 24 * 8


# --- the calibration --------------------------------------------------


def test_calibration_refuses_without_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "peaks.json"
    assert calibrate_peaks.main(["--out", str(out)]) == 1
    assert not out.exists()
    assert "no CUDA device" in capsys.readouterr().err


def test_calibration_refuses_vmem_from_the_twin(port_cfg):
    with pytest.raises(RuntimeError, match="plain twin"):
        calibrate_peaks.measure(port_cfg, "SOL_VMEM", CPU)


def test_calibration_row_on_the_cpu_names_its_basis(port_cfg):
    """``measure`` of another SOL benchmark: the rate comes from the
    quantity TARGETS names, over the saturated basis (a CPU run has no
    CUDA-event tier)."""
    cfg = port_cfg.replace(pipeline_depth=4, saturated_reps=2)
    row = calibrate_peaks.measure(cfg, "SOL_HBM", CPU)
    assert row["peak_key"] == "hbm_bytes_per_sec"
    assert row["basis"] == "saturated"
    assert row["measured_rate"] == pytest.approx(
        row["cost"]["hbm_bytes"] / (row["basis_ms"] / 1e3))


# --- the CLI -----------------------------------------------------------


@pytest.mark.parametrize("argv,key", [
    (["--solFmaK", "64"], "sol_fma_k"),
    (["--solFmaMiB", "2"], "sol_fma_mib"),
    (["--solVmemMiB", "1"], "sol_vmem_mib"),
    (["--solStreamMiB", "16"], "sol_stream_mib"),
    (["--solMatmulDim", "256"], "sol_matmul_dim"),
])
def test_sol_flags_parse_like_the_reference(argv, key):
    cfg, names, err = cli.parse_args(argv)
    j_cfg, j_names, j_err = jax_cli.parse_args(argv)
    assert err is None and j_err is None and names == j_names
    assert getattr(cfg, key) == getattr(j_cfg, key)
    assert getattr(cfg, key) != getattr(BenchConfig(), key)


def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device="cpu")
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("name,extra", [
    ("SOL_VPU", ["--solFmaK", "16", "--solFmaMiB", "1"]),
    ("SOL_MXU_int8", ["--solMatmulDim", "64"]),
])
def test_sol_cli_on_cpu_validates_without_roofline(name, extra):
    rc, lines = _run_cli(["--benchmark", name, "--nRuns", "2", "--warmup",
                          "1", "--json"] + extra)
    assert rc == 0, lines[-20:]
    rec = json.loads("\n".join(lines[lines.index("{"):lines.index("}") + 1]))
    assert rec["validation"]["status"] == "SUCCESS"
    assert "roofline" not in rec.get("metadata", {})
    assert rec["device"]["platform"] == "cpu"


def test_printed_summary_carries_the_roofline_line():
    from gpuaudiobench_tpu_torch.harness.base import BenchmarkResult
    from gpuaudiobench_tpu_torch.harness.output import print_results
    from gpuaudiobench_tpu_torch.harness.statistics import (
        calculate_statistics,
    )

    result = BenchmarkResult(benchmark_name="SOL_HBM",
                             latencies=[1.0, 1.1],
                             statistics=calculate_statistics([1.0, 1.1]))
    result.metadata = {"roofline": dict(
        roofline.roofline_metrics({"flops": 1e6, "hbm_bytes": 1.34e8,
                                   "unit": "vpu"}, 0.05), basis="device")}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_results(result, BenchConfig())
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("Roofline [device]")]
    assert line and "bandwidth-bound" in line[0] and "spec-estimate" in line[0]
