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
from gpuaudiobench_tpu_torch import cli, registry
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


@pytest.mark.parametrize("name", ["NeuralAmpLSTM", "NeuralAmp",
                                  "MultiChipSuite"])
def test_unported_benchmark_exits_1_naming_roadmap(name):
    """MultiChipSuite is still to be ported: it exits 1 naming its ROADMAP
    item. NeuralAmp and NeuralAmpLSTM are ported (item 15): their cases
    run a toy CPU config, validate and exit 0."""
    argv = ["--benchmark", name, "--nRuns", "1"]
    if name in registry.UNPORTED_BENCHMARKS:
        rc, lines = _run(cli.main, argv, device="cpu")
        assert rc == 1
        assert any("ROADMAP" in ln and name in ln for ln in lines)
        return
    rc, lines = _run(cli.main, argv + TOY + [
        "--bufferSize", "64", "--neuralampChannels", "16",
        "--neuralampLayers", "3"], device="cpu")
    assert rc == 0, lines[-20:]
    assert _json(lines)["validation"]["status"] == "SUCCESS"


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


# The flags the port refused until they were ported (pinned staging, the
# datacopy family, DAW-sim and the overlapped infeed; then the CSV writer,
# PartConv and DAWSessionMix; then NeuralAmp's): each now runs a toy
# benchmark and reaches the configuration under the reference's field.
RETIRED_REFUSALS = {
    "--dawsim": ([], {"dawsim": True}),
    "--dawsim-mode": (["sleep"], {"dawsim_mode": "sleep"}),
    "--dawsim-jitter-us": (["250"], {"dawsim_jitter_us": 250.0}),
    "--overlapDepth": (["4"], {"overlap_depth": 4}),
    "--overlapReps": (["2"], {"overlap_reps": 2}),
    "--transferMiB": (["1"], {"transfer_mib": 1}),
    "--category": (["session"], {}),
    "--csvSchema": (["metal"], {"csv_schema": "metal"}),
    "--latenciesFile": (["lat.txt"], {"latencies_file": "lat.txt"}),
    "--partconvForm": (["ring"], {"partconv_form": "ring"}),
    "--partconvTailChunk": (["2"], {"partconv_tail_chunk": 2}),
    "--partconvHDtype": (["f16"], {"partconv_h_dtype": "f16"}),
    "--sessionEqStages": (["3"], {"session_eq_stages": 3}),
    "--neuralampChannels": (["16"], {"neuralamp_channels": 16}),
    "--neuralampLayers": (["3"], {"neuralamp_layers": 3}),
    "--neuralampDtype": (["bf16"], {"neuralamp_dtype": "bf16"}),
}
# The benchmark each retired flag runs (gain where it is not named).
RETIRED_RUNS = {"--transferMiB": "datacopy5050", "--category":
                "DAWSessionMix", "--sessionEqStages": "DAWSessionMix",
                "--partconvForm": "PartConv", "--partconvTailChunk":
                "PartConv", "--partconvHDtype": "PartConv",
                "--neuralampChannels": "NeuralAmpLSTM",
                "--neuralampLayers": "NeuralAmp",
                "--neuralampDtype": "NeuralAmp"}


@pytest.mark.parametrize("flag", sorted(RETIRED_REFUSALS))
def test_retired_refusal_flag_now_runs(flag):
    values, fields = RETIRED_REFUSALS[flag]
    name = RETIRED_RUNS.get(flag, "gain")
    argv = ["--nTracks", "8", "--nRuns", "2", "--warmup", "1", "--json",
            flag] + values
    if flag != "--category":
        argv = ["--benchmark", name] + argv
    if name in ("PartConv", "DAWSessionMix"):
        argv += ["--bufferSize", "64", "--irLength", "300"]
    if flag == "--partconvTailChunk":
        argv += ["--partconvForm", "nupols"]
    if name.startswith("NeuralAmp"):
        argv += ["--bufferSize", "64"]
        for knob, value in (("--neuralampChannels", "16"),
                            ("--neuralampLayers", "3")):
            if knob != flag:
                argv += [knob, value]
    if flag in ("--dawsim-mode", "--dawsim-jitter-us"):
        argv.append("--dawsim")
    if flag == "--overlapReps":
        argv += ["--overlapDepth", "4"]
    cfg, names, err = cli.parse_args(argv)
    jcfg, jnames, jerr = jax_cli.parse_args(argv)
    assert err is None and jerr is None and names == jnames == [name]
    for key, want in fields.items():
        assert getattr(cfg, key) == getattr(jcfg, key) == want
    rc, lines = _run(cli.main, argv, device="cpu")
    assert rc == 0, lines[-20:]
    rec = _json(lines)
    assert rec["validation"]["status"] == "SUCCESS"
    if cfg.dawsim:
        assert rec["deadline"]["pacer"] in ("native", "python")
        assert "miss_rate_percent" in rec["deadline"]
    if cfg.overlap_depth > 1:
        assert rec["overlapped"]["depth"] == 4
        assert rec["overlapped"]["reps"] == cfg.overlap_reps
    if flag == "--transferMiB":
        assert rec["metadata"]["inputFloats"] == 131072
    if name == "PartConv":
        assert rec["metadata"]["formResolved"] == cfg.partconv_form
        assert rec["metadata"]["hDtype"] == cfg.partconv_h_dtype
    if flag == "--sessionEqStages":
        assert rec["metadata"]["eqStages"] == 3
    if name.startswith("NeuralAmp"):
        md = rec["metadata"]
        assert (md["channels"], md["dtype"]) == (cfg.neuralamp_channels,
                                                 cfg.neuralamp_dtype)
        assert md.get("layers", 3) == 3


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
    """Since the CSV writer was ported, ``--outputfile`` without ``--json``
    no longer exits 1: it appends the CUDA-schema CSV row, header first,
    after the printed summary (the name is kept from the refusal)."""
    out = tmp_path / "r.csv"
    rc, lines = _run(cli.main, ["--benchmark", "IIRFilter", "--nTracks", "8",
                                "--nRuns", "3", "--warmup", "1",
                                "--outputfile", str(out), "--latenciesFile",
                                str(tmp_path / "lat.txt")], device="cpu")
    assert rc == 0 and not any("ROADMAP" in ln for ln in lines)
    assert f"Results saved to: {out}" in lines
    header, row = out.read_text().splitlines()
    assert header == (jax_output.CSV_HEADER + jax_output.CSV_CONTEXT_COLS)
    assert row.startswith("IIRFilter,48000,512,8,3,")
    assert row.endswith(",wall,,cpu")


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
    rc, lines = _run(cli.main, ["--benchmarkFilter",
                                "=MultiChipSuite,=IIRFilter",
                                "--no-device-timing"] + TOY, device="cpu")
    assert rc == 1
    assert any("MultiChipSuite" in ln and "ROADMAP" in ln for ln in lines)
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
                      "Conv1D_accel", "DWG1DNaive", "DWG1DAccel", "FDTD3D",
                      "RndMemRead", "PartConv", "DAWSessionMix",
                      "NeuralAmp", "NeuralAmpLSTM", "SOL_VPU", "SOL_VMEM", "SOL_HBM",
                      "SOL_MXU_bf16", "SOL_MXU_f32", "SOL_MXU_int8",
                      "datacopy0199", "datacopy2080", "datacopy5050",
                      "datacopy8020", "datacopy9901"}


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


@pytest.mark.parametrize("argv,key", [
    (["--poolMiB", "64"], "rndmem_pool_mb"),
    (["--dwgMinLen", "50"], "dwg_min_length"),
    (["--dwgMaxLen", "900"], "dwg_max_length"),
    (["--fdtdRoom", "20"], "fdtd_room"),
    (["--fdtdPerTrackReceivers"], "fdtd_per_track_receivers"),
])
def test_slice_flags_parse_like_the_reference(argv, key):
    cfg, names, err = cli.parse_args(argv)
    j_cfg, j_names, j_err = jax_cli.parse_args(argv)
    assert err is None and j_err is None and names == j_names
    assert getattr(cfg, key) == getattr(j_cfg, key)
    assert getattr(cfg, key) != getattr(BenchConfig(), key)


@pytest.mark.parametrize("argv,needle", [
    (["--fdtdRoom", "7"], "fdtd_room must be in [8, 128]"),
    (["--fdtdRoom", "129"], "fdtd_room must be in [8, 128]"),
    (["--dwgMinLen", "3"], "dwg_min_length must be >= 4"),
    (["--dwgMinLen", "300", "--dwgMaxLen", "200"], "dwg_max_length (200)"),
    (["--poolMiB", "half"], "invalid value"),
])
def test_slice_flags_reject_like_the_reference(argv, needle):
    rc, lines = _run(cli.main, argv, device="cpu")
    assert rc == 1 and needle in lines[-1]
    assert jax_cli.parse_args(argv)[2] is not None


SLICE_ARGS = {
    "RndMemRead": ["--poolMiB", "1"],
    "DWG1DNaive": ["--dwgMinLen", "20", "--dwgMaxLen", "200"],
    "DWG1DAccel": ["--dwgMinLen", "20", "--dwgMaxLen", "200"],
    "FDTD3D": ["--fdtdRoom", "8", "--bufferSize", "16"],
}


@pytest.mark.parametrize("name", sorted(SLICE_ARGS))
def test_slice_json_keys_are_a_subset_of_the_reference(name):
    argv = ["--benchmark", name, "--nTracks", "8", "--nRuns", "3",
            "--warmup", "1", "--json", "--no-device-timing"] + SLICE_ARGS[name]
    rc, lines = _run(cli.main, argv + ["--pipelineDepth", "8",
                                       "--saturatedReps", "2"], device="cpu")
    assert rc == 0, lines[-20:]
    ours = _json(lines)
    rc_j, jlines = _run(jax_cli.main, argv)
    assert rc_j == 0, jlines[-20:]
    theirs = _json(jlines)
    assert ours["validation"]["status"] == theirs["validation"]["status"]
    assert ours["benchmark"] == theirs["benchmark"] == name
    assert ours["configuration"] == theirs["configuration"]
    ours.pop("saturated")  # asked of the port only
    assert _paths(ours) <= _paths(theirs), _paths(ours) - _paths(theirs)


@pytest.mark.parametrize("category", ["transfer", "basic", "dsp", "physical",
                                      "memory", "session", "speedoflight"])
def test_category_selects_like_the_reference(category):
    argv = ["--category", category, "--benchmarkFilter", "=gain"]
    cfg, names, err = cli.parse_args(argv)
    j_cfg, j_names, j_err = jax_cli.parse_args(argv)
    assert err is None and j_err is None and names == j_names


@pytest.mark.parametrize("category,item", [("neural", "queue 1, item 15"),
                                           ("multichip", "queue 1, item 18")])
def test_category_of_unported_benchmarks_exits_1_naming_roadmap(category,
                                                                item):
    """multichip holds benchmarks still to be ported: it exits 1 naming
    their item. neural's two (item 15) are ported: the category runs both
    on the CPU at toy size and exits 0."""
    assert jax_cli.parse_args(["--category", category])[2] is None
    if any(n in registry.UNPORTED_BENCHMARKS
           for n in registry.CATEGORIES[category]):
        rc, lines = _run(cli.main, ["--category", category], device="cpu")
        assert rc == 1 and lines[-1].endswith(f"see ROADMAP.md {item}")
        return
    rc, lines = _run(cli.main, ["--category", category] + TOY + [
        "--bufferSize", "64", "--neuralampChannels", "16",
        "--neuralampLayers", "3"], device="cpu")
    assert rc == 0, lines[-20:]
    start, end = lines.index("["), len(lines) - 1 - lines[::-1].index("]")
    recs = json.loads("\n".join(lines[start:end + 1]))
    assert [r["benchmark"] for r in recs] == registry.CATEGORIES[category]
    assert all(r["validation"]["status"] == "SUCCESS" for r in recs)


def test_unknown_category_exits_1():
    rc, lines = _run(cli.main, ["--category", "brass"], device="cpu")
    assert rc == 1 and "unknown category 'brass'" in lines[-1]
    assert "unknown category 'brass'" in jax_cli.parse_args(
        ["--category", "brass"])[2]
