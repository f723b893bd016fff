"""The PyTorch port's CLI and JSON output against the JAX package's, on
the CPU at toy size (``main(argv, device="cpu")``; IIRFilter at 8 tracks).

The port writes a subset of the reference's JSON keys, under the same
names; what it cannot fill it leaves out. Its blocks/s basis never takes a
marginal that is faster than the device tier or inside its own noise (the
reference's ``harness/output.py:89`` takes any marginal above 0).
"""

import contextlib
import io
import json
import pathlib
import re

import pytest

from gpuaudiobench_tpu import cli as jax_cli
from gpuaudiobench_tpu.harness import output as jax_output
from gpuaudiobench_tpu.harness.base import BenchmarkResult as JaxResult
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import output
from gpuaudiobench_tpu_torch.harness.base import BenchmarkResult
from gpuaudiobench_tpu_torch.harness.statistics import calculate_statistics

REPO = pathlib.Path(__file__).resolve().parent.parent
TOY = ["--nTracks", "8", "--nRuns", "3", "--warmup", "1",
       "--pipelineDepth", "8", "--saturatedReps", "3", "--json"]


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue().splitlines()


def _json(lines):
    start = lines.index("{")
    end = len(lines) - 1 - lines[::-1].index("}")
    return json.loads("\n".join(lines[start:end + 1]))


def _paths(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _paths(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("extra", [[], ["--iirForm", "blockstate",
                                        "--iirBlockM", "16"]])
def test_iir_json_keys_are_a_subset_of_the_reference(extra):
    argv = ["--benchmark", "IIRFilter"] + TOY + extra
    rc, lines = _run(cli.main, argv, device="cpu")
    assert rc == 0, lines[-20:]
    ours = _json(lines)
    rc_j, jlines = _run(lambda a: jax_cli.main(a), argv)
    assert rc_j == 0
    theirs = _json(jlines)
    assert _paths(ours) <= _paths(theirs), _paths(ours) - _paths(theirs)
    assert ours["benchmark"] == "IIRFilter"
    assert ours["validation"]["status"] == "SUCCESS"
    assert ours["device_statistics"]["method"] == "wall"  # the CPU's label
    assert ours["device"]["platform"] == "cpu"
    assert ours["metadata"]["impl"] == "torch-plain"
    assert ours["configuration"] == theirs["configuration"]
    assert ours["metadata"]["coefficients"] == theirs["metadata"][
        "coefficients"]
    assert ours["saturated"]["blocks_per_sec_basis"] in ("marginal",
                                                          "amortized")


def test_biquad_chain_runs_through_the_cli():
    rc, lines = _run(cli.main, ["--benchmark", "BiquadChain",
                                "--no-device-timing"] + TOY, device="cpu")
    assert rc == 0, lines[-20:]
    rec = _json(lines)
    assert "device_statistics" not in rec
    assert rec["validation"]["status"] == "SUCCESS"
    assert rec["metadata"]["numStages"] == 10


def test_printed_summary():
    rc, lines = _run(cli.main, ["--benchmark", "IIRFilter", "--nTracks", "8",
                                "--nRuns", "3", "--warmup", "1"],
                     device="cpu")
    assert rc == 0
    text = "\n".join(lines)
    assert "=== IIRFilter ===" in text
    assert re.search(r"Device Median: +[0-9.]+ ms \[wall\]", text)
    assert "Validation passed" in text
    assert lines[-1] == "Done"


def test_list_prints_the_reference_names():
    rc, ours = _run(cli.main, ["--list"])
    rc_j, theirs = _run(jax_cli.main, ["--list"])
    assert rc == rc_j == 0
    assert ours == theirs


def test_help_names_every_ported_flag_and_benchmark():
    rc, lines = _run(cli.main, ["--help"])
    text = "\n".join(lines)
    assert rc == 0
    for flag in list(cli.VALUE_FLAGS) + list(cli.SWITCHES) + [
            "--benchmarkFilter", "--list"]:
        assert flag in text, flag
    for name in ("IIRFilter", "BiquadChain", "ModalFilterBank"):
        assert name in text


@pytest.mark.parametrize("name", ["DWG1DNaive", "RndMemRead", "FDTD3D"])
def test_unported_benchmark_exits_1_naming_roadmap(name):
    rc, lines = _run(cli.main, ["--benchmark", name, "--nRuns", "1"],
                     device="cpu")
    assert rc == 1
    assert any("ROADMAP" in ln and name in ln for ln in lines)


def test_default_benchmark_is_the_reference_default():
    cfg, names, err = cli.parse_args([])
    assert err is None and names == [jax_cli.DEFAULT_BENCHMARK]


@pytest.mark.parametrize("flag", sorted(cli.UNPORTED_FLAGS))
def test_unported_flag_exits_1_naming_roadmap(flag):
    rc, lines = _run(cli.main, ["--benchmark", "IIRFilter", flag, "4"],
                     device="cpu")
    assert rc == 1
    assert lines == [f"Error: {flag} is not ported to the PyTorch CLI yet; "
                     f"see ROADMAP.md {cli.UNPORTED_FLAGS[flag]}"]


def test_every_reference_flag_is_ported_or_refused():
    """Each flag of the reference's CLI is either parsed by the port or
    named in its refusal table; none is silently ignored."""
    text = (REPO / "gpuaudiobench_tpu" / "cli.py").read_text()
    flags = set(re.findall(r'"(--[A-Za-z][A-Za-z-]*)"', text))
    known = (set(cli.VALUE_FLAGS) | set(cli.SWITCHES)
             | set(cli.UNPORTED_FLAGS)
             | {"--help", "--list", "--benchmarkFilter"})
    assert flags and flags <= known, flags - known


@pytest.mark.parametrize("argv,needle", [
    (["--nTracks"], "requires an argument"),
    (["--nTracks", "many"], "invalid value"),
    (["--iirForm", "fir"], "invalid iir form"),
    (["--iirBlockM", "1"], "iir_block_m"),
    (["--convEdgeMode", "wrap"], "invalid conv edge mode"),
    (["--irLength", "long"], "invalid value"),
    (["--bogus"], "unknown argument"),
    (["--benchmarkFilter", "/zzz/"], "no benchmarks match"),
])
def test_bad_arguments_exit_1(argv, needle):
    rc, lines = _run(cli.main, argv, device="cpu")
    assert rc == 1 and needle in lines[-1]


def test_outputfile_without_json_exits_1_naming_roadmap(tmp_path):
    out = tmp_path / "r.csv"
    rc, lines = _run(cli.main, ["--benchmark", "IIRFilter", "--outputfile",
                                str(out)], device="cpu")
    assert rc == 1 and "ROADMAP" in lines[-1] and not out.exists()


def test_outputfile_with_json_writes_the_json(tmp_path):
    out = tmp_path / "r.json"
    rc, lines = _run(cli.main, ["--benchmark", "IIRFilter", "--outputfile",
                                str(out), "--no-device-timing"] + TOY,
                     device="cpu")
    assert rc == 0
    assert json.loads(out.read_text())["benchmark"] == "IIRFilter"
    assert f"JSON results saved to: {out}" in lines


def test_benchmark_filter_selects_like_the_reference():
    cfg, names, err = cli.parse_args(["--benchmarkFilter", "/^iir/,=gain"])
    j_cfg, j_names, j_err = jax_cli.parse_args(
        ["--benchmarkFilter", "/^iir/,=gain"])
    assert err is None and j_err is None and names == j_names
    assert cli.matches_filter("BiquadChain", ["biquad"])
    assert not cli.matches_filter("BiquadChain", ["=biquad"])


def test_filter_run_goes_on_past_a_failure_and_exits_1():
    """A filter that selects an unported benchmark and a ported one runs
    the ported one and still exits 1 (the reference's suite
    resilience)."""
    rc, lines = _run(cli.main, ["--benchmarkFilter", "=FDTD3D,=IIRFilter",
                                "--no-device-timing"] + TOY, device="cpu")
    assert rc == 1
    assert any("FDTD3D" in ln and "ROADMAP" in ln for ln in lines)
    assert _json(lines)["benchmark"] == "IIRFilter"


def test_a_benchmark_that_raises_exits_1(monkeypatch):
    from gpuaudiobench_tpu_torch.models.iir import IIRBenchmark

    def boom(self):
        raise RuntimeError("setup failed")

    monkeypatch.setattr(IIRBenchmark, "setup", boom)
    rc, lines = _run(cli.main, ["--benchmark", "IIRFilter"], device="cpu")
    assert rc == 1
    assert any("RuntimeError: setup failed" in ln for ln in lines)


def test_main_defaults_to_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--benchmark", "IIRFilter"])


# -- the blocks/s basis ---------------------------------------------------

def _result(cls, marginals, device_median=None, sat=(1.0, 1.0, 1.0)):
    r = cls()
    r.latencies = [2.0, 2.1, 2.2]
    r.statistics = calculate_statistics(r.latencies)
    r.pipeline_depth = 8
    r.saturated_latencies = list(sat)
    r.saturated_statistics = calculate_statistics(r.saturated_latencies)
    r.saturated_lo_depth = 2
    r.saturated_marginal_latencies = list(marginals)
    r.saturated_marginal_statistics = calculate_statistics(marginals)
    if device_median is not None:
        r.device_latencies = [device_median] * 3
        r.device_statistics = calculate_statistics(r.device_latencies)
    return r


@pytest.mark.parametrize("marginals,device,basis", [
    ([0.50, 0.51, 0.49], 0.45, "marginal"),   # resolved, above the device
    ([0.50, 0.51, 0.49], None, "marginal"),   # no device tier
    ([0.10, 0.11, 0.09], 0.45, "amortized"),  # faster than the device
    ([0.02, -0.05, 0.30], None, "amortized"),  # inside its own noise
    ([-0.01, -0.02, -0.03], None, "amortized"),
])
def test_basis_never_reports_a_marginal_faster_than_the_device(
        marginals, device, basis):
    r = _result(BenchmarkResult, marginals, device)
    sat_p50, marg_p50, bps, got = output.saturated_basis(r)
    assert got == basis
    if device is not None:
        assert 1000.0 / bps >= device  # never faster than the device tier
    if basis == "amortized":
        assert bps == pytest.approx(1000.0 / sat_p50)
    rec = output.generate_json_results(r, BenchConfig())
    assert rec["saturated"]["blocks_per_sec_basis"] == basis


def test_reference_basis_fault_is_not_copied():
    """Where the reference takes a marginal faster than its own device
    tier, the port falls back to the amortized basis."""
    marginals, device = [0.10, 0.11, 0.09], 0.45
    jr = _result(JaxResult, marginals, device)
    assert jax_output._saturated_derived(jr)[3] == "marginal"
    r = _result(BenchmarkResult, marginals, device)
    assert output.saturated_basis(r)[3] == "amortized"


def test_marginal_noise_is_the_median_absolute_deviation():
    assert output.marginal_noise([]) == 0.0
    assert output.marginal_noise([1.0, 2.0, 4.0]) == 1.0


def test_json_of_a_result_without_tiers_leaves_their_keys_out():
    r = BenchmarkResult(benchmark_name="x", latencies=[1.0, 2.0])
    r.statistics = calculate_statistics(r.latencies)
    rec = output.generate_json_results(r, BenchConfig())
    for key in ("device_statistics", "saturated", "validation", "metadata"):
        assert key not in rec
    jr = JaxResult(benchmark_name="x", latencies=[1.0, 2.0])
    jr.statistics = calculate_statistics(jr.latencies)
    assert _paths(rec) <= _paths(jax_output.generate_json_results(
        jr, BenchConfig()))


def test_help_marks_the_ported_benchmarks():
    rc, lines = _run(cli.main, ["--help"])
    marked = {ln.split()[0][1:] for ln in lines if ln.startswith(" *")}
    assert marked == {"IIRFilter", "ModalFilterBank", "BiquadChain", "NoOp",
                      "gain", "GainStats", "FFT1D", "Conv1D",
                      "Conv1D_accel"}


@pytest.mark.parametrize("argv,want", [
    (["--benchmark", "Conv1D", "--irLength", "40", "--convEdgeMode",
      "bleed"], {"irLength": 40, "edgeMode": "bleed"}),
    (["--benchmark", "Conv1D", "--irLength", "16"],
     {"irLength": 16, "edgeMode": "clamp"}),
    (["--benchmark", "Conv1D_accel", "--irLength", "100"],
     {"irLength": 100, "fftSize": 1024}),
])
def test_conv_flags_reach_the_benchmark(argv, want):
    rc, lines = _run(cli.main, argv + TOY, device="cpu")
    assert rc == 0, lines[-20:]
    rec = _json(lines)
    assert rec["validation"]["status"] == "SUCCESS"
    for k, v in want.items():
        assert rec["metadata"][k] == v


@pytest.mark.parametrize("name", ["NoOp", "gain", "GainStats", "FFT1D",
                                  "Conv1D", "Conv1D_accel"])
def test_new_benchmarks_json_keys_are_a_subset_of_the_reference(name):
    extra = ["--irLength", "16"] if name.startswith("Conv1D") else []
    rc, lines = _run(cli.main, ["--benchmark", name] + TOY + extra,
                     device="cpu")
    assert rc == 0, lines[-20:]
    ours = _json(lines)
    rc_j, jlines = _run(jax_cli.main,
                        ["--benchmark", name, "--nTracks", "8", "--nRuns",
                         "3", "--warmup", "1", "--json", "--no-device-timing"]
                        + extra)
    assert rc_j == 0, jlines[-20:]
    theirs = _json(jlines)
    assert ours["validation"]["status"] == theirs["validation"]["status"]
    assert ours["benchmark"] == theirs["benchmark"] == name
