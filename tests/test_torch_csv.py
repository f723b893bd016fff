"""The PyTorch port's CSV writer, JSON-to-CSV derivation and latency file
(``harness/output.py``) against the JAX package's, on the CPU.

The port's rows and files are the reference's text, byte for byte, on the
same results and JSON dicts, except where the reference's two CSV
surfaces disagree with each other (the marginal tier asked for and
absent: ``gpuaudiobench_tpu/harness/output.py:155``): there the port's
live row and its JSON-derived row are the same text, the reference's
live row.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from gpuaudiobench_tpu.harness import output as jax_output
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness import output
from gpuaudiobench_tpu_torch.harness.base import BenchmarkResult
from gpuaudiobench_tpu_torch.harness.statistics import calculate_statistics

CPU = torch.device("cpu")


def _result(name="PartConv", sat=None, marg=None, device=None,
            method="wall"):
    r = BenchmarkResult(benchmark_name=name, buffer_size=512,
                        track_count=64)
    r.latencies = [3.25, 2.5, 4.125, 2.75, 3.0]
    r.statistics = calculate_statistics(r.latencies)
    if device is not None:
        r.device_latencies = list(device)
        r.device_statistics = calculate_statistics(r.device_latencies)
        r.device_timing_method = method
    if sat is not None:
        r.pipeline_depth = 64
        r.saturated_latencies = list(sat)
        r.saturated_statistics = calculate_statistics(r.saturated_latencies)
    if marg is not None:
        r.saturated_lo_depth = 16
        r.saturated_marginal_latencies = list(marg)
        r.saturated_marginal_statistics = calculate_statistics(marg)
    return r


SAT = [0.52, 0.5, 0.55, 0.51, 0.53]
MARG = [0.49, 0.5, 0.48, 0.5, 0.49]
CASES = {
    # (result, cfg knobs)
    "round trip only": (lambda: _result(device=[0.4, 0.41, 0.39]), {}),
    "no device tier": (lambda: _result(), {"device_timing": False}),
    "saturated + marginal": (
        lambda: _result(sat=SAT, marg=MARG, device=[0.45, 0.46, 0.44]),
        {"pipeline_depth": 64}),
    "marginal faster than the device tier": (
        lambda: _result(sat=SAT, marg=[0.2, 0.21, 0.19],
                        device=[0.45, 0.46, 0.44]),
        {"pipeline_depth": 64}),
    "saturated, marginal off": (
        lambda: _result(sat=SAT, device=[0.45, 0.46, 0.44]),
        {"pipeline_depth": 64, "saturated_marginal": False}),
    "saturated, depth 2": (
        lambda: _result(sat=SAT, device=[0.45, 0.46, 0.44]),
        {"pipeline_depth": 2}),
    "no stream under --pipelineDepth": (
        lambda: _result(device=[0.45]), {"pipeline_depth": 64}),
    "marginal absent": (
        lambda: _result(sat=SAT, device=[0.45, 0.46, 0.44]),
        {"pipeline_depth": 64}),
}
# Where the reference's live row takes another blocks/s basis than the
# port's (its output.py:89 fault, which saturated_basis avoids), and
# where its two surfaces disagree (output.py:155).
BASIS_DIFFERS = {"marginal faster than the device tier"}
REFERENCE_SURFACES_DIFFER = {"marginal absent",
                             "no stream under --pipelineDepth"}


def _case(name):
    make, knobs = CASES[name]
    return make(), BenchConfig(**knobs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_live_row_equals_the_derived_row(name, tmp_path):
    result, cfg = _case(name)
    path = tmp_path / "r.csv"
    output.write_csv_results(result, cfg, str(path), CPU)
    rec = output.generate_json_results(result, cfg, CPU)
    derived = output.csv_from_json_results([rec])
    assert path.read_text() == derived
    if name == "no stream under --pipelineDepth":
        assert rec["saturated"] == {"pipeline_depth": 64, "marginal": None,
                                    "skipped": "no streaming mode"}
        assert path.read_text().splitlines()[1].endswith(",,,,,,,wall,,cpu")
    if name == "marginal absent":
        assert rec["saturated"]["marginal"] is None
        assert path.read_text().splitlines()[1].split(",")[19] == "amortized"


@pytest.mark.parametrize("name", sorted(set(CASES) - BASIS_DIFFERS))
def test_live_row_is_the_references(name, tmp_path):
    """The reference's writer on the same result and configuration writes
    the same bytes (its timing environment on the CPU is "cpu", as the
    port's is)."""
    result, cfg = _case(name)
    ours, ref = tmp_path / "ours.csv", tmp_path / "ref.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        output.write_csv_results(result, cfg, str(ours), CPU)
        jax_output.write_csv_results(result, cfg, str(ref))
    assert ours.read_text() == ref.read_text()


@pytest.mark.parametrize("name", sorted(set(CASES) - REFERENCE_SURFACES_DIFFER))
def test_derived_rows_are_the_references(name):
    result, cfg = _case(name)
    rec = output.generate_json_results(result, cfg, CPU)
    assert (output.csv_from_json_results([rec])
            == jax_output.csv_from_json_results([rec]))


def test_derived_rows_of_a_suite_are_the_references():
    """Several JSON results in one CSV: one header, a row each; a result
    without a saturated section gets empty saturated columns."""
    recs = [output.generate_json_results(*_case(n), CPU)
            for n in ("saturated + marginal", "round trip only",
                      "saturated, marginal off")]
    ours = output.csv_from_json_results(recs)
    assert ours == jax_output.csv_from_json_results(recs)
    assert len(ours.splitlines()) == 4


def test_reference_basis_fault_is_not_copied(tmp_path):
    """The marginal tier asked for and absent: the reference's live row
    names a basis, its derived row leaves the two columns empty; the
    port's live and derived rows are both the reference's live row."""
    result, cfg = _case("marginal absent")
    ref_live = tmp_path / "ref.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        jax_output.write_csv_results(result, cfg, str(ref_live))
    rec = output.generate_json_results(result, cfg, CPU)
    ref_rec = json.loads(json.dumps(rec))
    del ref_rec["saturated"]["marginal"]  # the reference's JSON omits it
    ref_derived = jax_output.csv_from_json_results([ref_rec])
    assert ref_live.read_text() != ref_derived
    assert ",,amortized," in ref_live.read_text()
    ours = output.csv_from_json_results([rec])
    assert ours == ref_live.read_text()


def test_reference_columns_fault_is_not_copied(tmp_path):
    """The saturated tier asked for of a benchmark without a streaming
    mode: the reference's derived CSV has no saturated columns, its live
    one has them empty; the port's derived CSV is the reference's live
    one."""
    result, cfg = _case("no stream under --pipelineDepth")
    ref_live = tmp_path / "ref.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        jax_output.write_csv_results(result, cfg, str(ref_live))
    rec = output.generate_json_results(result, cfg, CPU)
    ref_rec = json.loads(json.dumps(rec))
    del ref_rec["saturated"]  # the reference's JSON has no such section
    assert jax_output.csv_from_json_results([ref_rec]) != ref_live.read_text()
    assert output.csv_from_json_results([rec]) == ref_live.read_text()


@pytest.mark.parametrize("name", ["round trip only", "saturated + marginal"])
def test_metal_schema_is_the_references(name, tmp_path):
    result, _ = _case(name)
    cfg = BenchConfig(csv_schema="metal", pipeline_depth=64)
    ours, ref = tmp_path / "ours.csv", tmp_path / "ref.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):  # one header, two rows
            output.write_csv_results(result, cfg, str(ours), CPU)
            jax_output.write_csv_results(result, cfg, str(ref))
    assert ours.read_text() == ref.read_text()
    lines = ours.read_text().splitlines()
    assert lines[0] == output.METAL_CSV_HEADER == jax_output.METAL_CSV_HEADER
    assert len(lines) == 3


def test_headers_are_the_references():
    for key in ("CSV_HEADER", "CSV_SATURATED_COLS", "CSV_MARGINAL_COLS",
                "CSV_CONTEXT_COLS", "METAL_CSV_HEADER"):
        assert getattr(output, key) == getattr(jax_output, key), key


@pytest.mark.parametrize("first,second", [
    ({"csv_schema": "metal"}, {}),
    ({}, {"csv_schema": "metal"}),
    ({}, {"pipeline_depth": 64}),
    ({"pipeline_depth": 64}, {"pipeline_depth": 64,
                              "saturated_marginal": False}),
])
def test_appending_another_schema_is_refused(first, second, tmp_path):
    result, _ = _case("saturated + marginal")
    path = tmp_path / "r.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        output.write_csv_results(result, BenchConfig(**first), str(path), CPU)
        before = path.read_text()
        with pytest.raises(ValueError, match="different CSV schema") as e:
            output.write_csv_results(result, BenchConfig(**second),
                                     str(path), CPU)
        with pytest.raises(ValueError) as je:
            jax_output.write_csv_results(result, BenchConfig(**second),
                                         str(path))
    assert str(e.value) == str(je.value)
    assert path.read_text() == before


def test_an_empty_file_gets_a_header(tmp_path):
    result, cfg = _case("round trip only")
    path = tmp_path / "r.csv"
    path.write_text("")
    with contextlib.redirect_stdout(io.StringIO()):
        output.write_csv_results(result, cfg, str(path), CPU)
    assert path.read_text().splitlines()[0] == output.CSV_HEADER + (
        output.CSV_CONTEXT_COLS)


@pytest.mark.parametrize("name", ["round trip only", "saturated + marginal"])
def test_latencies_file_is_the_references(name, tmp_path):
    result, _ = _case(name)
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    output.write_latencies_file(result, str(ours))
    jax_output.write_latencies_file(result, str(ref))
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.read_text().splitlines()[-1] == "3.000000"


def test_latencies_file_defaults_to_the_temp_dir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    result, _ = _case("round trip only")
    output.write_latencies_file(result)
    assert (tmp_path / "PartConv_latencies.txt").exists()


CLI_TOY = ["--nTracks", "8", "--bufferSize", "64", "--nRuns", "3",
           "--warmup", "1", "--irLength", "300", "--pipelineDepth", "8",
           "--saturatedReps", "2"]


@pytest.mark.parametrize("argv", [
    ["--benchmark", "PartConv"],
    ["--benchmark", "PartConv", "--partconvForm", "nupols",
     "--partconvTailChunk", "2"],
    ["--benchmark", "DAWSessionMix"],
    ["--benchmark", "IIRFilter", "--no-device-timing"],
])
def test_cli_without_json_writes_what_its_json_derives(argv, tmp_path,
                                                       monkeypatch):
    """A CLI run without --json prints the summary, then writes the latency
    file and the CSV row; the row equals the one derived from the JSON of
    the same run's result."""
    seen = []
    real = output.write_csv_results

    def capture(result, cfg, filename, device=None):
        seen.append((result, cfg, device))
        return real(result, cfg, filename, device)

    monkeypatch.setattr(output, "write_csv_results", capture)
    csv, lat = tmp_path / "r.csv", tmp_path / "lat.txt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + CLI_TOY + ["--outputfile", str(csv),
                                        "--latenciesFile", str(lat)],
                      device="cpu")
    text = buf.getvalue()
    assert rc == 0, text[-2000:]
    assert "Validation passed" in text and f"Results saved to: {csv}" in text
    (result, cfg, device), = seen
    rec = output.generate_json_results(result, cfg, device)
    assert csv.read_text() == output.csv_from_json_results([rec])
    assert rec["device"]["timing_environment"] == "cpu"
    assert lat.read_text().splitlines()[1] == "# Count: 3"


def test_cli_refuses_to_append_another_schema(tmp_path):
    csv = tmp_path / "r.csv"
    argv = ["--benchmark", "gain", "--nTracks", "8", "--nRuns", "2",
            "--warmup", "1", "--outputfile", str(csv), "--latenciesFile",
            str(tmp_path / "lat.txt")]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv + ["--csvSchema", "metal"], device="cpu") == 0
        before = csv.read_text()
        assert cli.main(argv, device="cpu") == 1
    assert csv.read_text() == before
    assert before.splitlines()[0] == output.METAL_CSV_HEADER


def test_csv_schema_rejects_like_the_reference():
    with pytest.raises(ValueError, match="invalid csv schema"):
        BenchConfig(csv_schema="tsv").validate()
    rc, _, err = cli.parse_args(["--csvSchema", "tsv"])
    assert rc is None and "invalid csv schema" in err


def test_json_run_writes_no_latency_file(tmp_path):
    lat = tmp_path / "lat.txt"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--benchmark", "gain", "--nTracks", "8", "--nRuns",
                       "2", "--json", "--latenciesFile", str(lat)],
                      device="cpu")
    assert rc == 0 and not os.path.exists(lat)
