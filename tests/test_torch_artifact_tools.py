"""The port's artifact tools on the CPU at toy sizes, held to the JAX
package's tools on the same records: ``tools/json_to_csv`` (the CLI's CSV
derivation as a command), ``tools/render_results`` (the suite and
roofline tables, ``--check``), ``tools/remeasure_rows``,
``tools/regen_artifacts`` (one run, everything derived) and
``tools/readme_headline`` (the port's own sentinels; the JAX block is
never touched)."""

import contextlib
import copy
import csv
import glob
import importlib.util
import io
import json
import os
import shutil
import sys

import pytest

from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.harness.output import csv_from_json_results
from gpuaudiobench_tpu_torch.tools import (
    json_to_csv,
    readme_headline,
    regen_artifacts,
    remeasure_rows,
    render_results,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = {"kind": "NVIDIA H100 80GB HBM3", "platform": "gpu",
        "timing_environment": "local", "power_limit": "700.00 W"}
JAX_BEGIN, JAX_END = "<!-- headline:begin -->", "<!-- headline:end -->"
SUITE_JSONS = sorted(glob.glob(os.path.join(ROOT, "docs",
                                            "RESULTS_r*_tpu_v5e.json")))


def _root_tool(name):
    """A repo-level tool of the JAX package, loaded by path (some import
    ``_pathfix`` as a sibling)."""
    tools_dir = os.path.join(ROOT, "tools")
    sys.path.insert(0, tools_dir)
    try:
        spec = importlib.util.spec_from_file_location(
            f"root_{name}", os.path.join(tools_dir, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools_dir)
    return mod


def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a, **kw)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def port_json(tmp_path_factory):
    """A JSON array of the port's CLI on the CPU: gain and IIRFilter at a
    toy size, with the saturated and marginal tiers."""
    path = str(tmp_path_factory.mktemp("runs") / "r.json")
    rc, out = _quiet(cli.main, [
        "--benchmarkFilter", "=gain,=IIRFilter", "--nTracks", "8",
        "--bufferSize", "64", "--nRuns", "4", "--pipelineDepth", "8",
        "--saturatedReps", "3", "--json", "--quiet", "--outputfile", path],
        device="cpu")
    assert rc == 0, out
    return path


def _records(path):
    with open(path) as f:
        return json.load(f)


def _rows(text):
    return list(csv.DictReader(io.StringIO(text)))


# -- json_to_csv --------------------------------------------------------------

def test_json_to_csv_is_csv_from_json_results(port_json, tmp_path):
    out = str(tmp_path / "r.csv")
    rc, text = _quiet(json_to_csv.main, [port_json, out], device="cpu")
    assert rc == 0
    assert text.strip() == f"wrote {out} (2 rows) from {port_json}"
    with open(out) as f:
        assert f.read() == csv_from_json_results(_records(port_json))


def test_json_to_csv_takes_an_object_as_one_row(port_json, tmp_path):
    one = str(tmp_path / "one.json")
    rec = _records(port_json)[1]
    with open(one, "w") as f:
        json.dump(rec, f)
    out = str(tmp_path / "one.csv")
    assert _quiet(json_to_csv.main, [one, out])[0] == 0
    with open(out) as f:
        text = f.read()
    assert text == csv_from_json_results([rec])
    assert [r["benchmark"] for r in _rows(text)] == ["IIRFilter"]


def test_json_to_csv_equals_the_jax_tool_but_the_documented_columns(
        port_json):
    """The JAX tool on the same records writes the same header and rows,
    but for ``blocks_per_sec_basis`` where a record's marginal is null
    (the port names the basis there; ROADMAP §3)."""
    root = _root_tool("json_to_csv")
    recs = _records(port_json)
    # One record with a null marginal, as a sub-noise run writes it.
    recs.append(copy.deepcopy(recs[0]))
    recs[-1]["saturated"]["marginal"] = None
    recs[-1]["saturated"]["blocks_per_sec_basis"] = "amortized"
    ours, theirs = json_to_csv.convert(recs), root.convert(recs)
    assert ours.splitlines()[0] == theirs.splitlines()[0]
    for rec, o, t in zip(recs, _rows(ours), _rows(theirs)):
        if (rec.get("saturated") or {}).get("marginal") is None:
            assert (o.pop("blocks_per_sec_basis"),
                    t.pop("blocks_per_sec_basis")) == ("amortized", "")
        assert o == t


# -- render_results -----------------------------------------------------------

@pytest.mark.parametrize("section", ["suite", "roofline"])
@pytest.mark.parametrize("src", SUITE_JSONS,
                         ids=[os.path.basename(p) for p in SUITE_JSONS])
def test_tables_equal_the_jax_renderers(src, section):
    root = _root_tool("render_results")
    results = _records(src)
    ours = render_results.RENDERERS[section](results)
    assert ours == root.RENDERERS[section](results)
    assert len(ours.splitlines()) >= 2


def test_r3_suite_has_every_row():
    results = _records(os.path.join(ROOT, "docs", "RESULTS_r3_tpu_v5e.json"))
    lines = render_results.render_suite(results).splitlines()
    assert len(lines) == 2 + len(results)
    assert render_results.render_roofline(results).count("\n") >= 2


def _doc(tmp_path, src):
    shutil.copy(src, tmp_path / "R.json")
    md = tmp_path / "R.md"
    md.write_text("# title\n\nprose\n\n"
                  "<!-- BEGIN generated:suite from R.json -->\n"
                  "<!-- END generated:suite -->\n\nmore prose\n\n"
                  "<!-- BEGIN generated:roofline from R.json -->\n"
                  "stale\n<!-- END generated:roofline -->\n")
    return str(md)


def test_render_then_check_then_drift(port_json, tmp_path, capsys):
    md = _doc(tmp_path, port_json)
    assert render_results.main([md, "--check"]) == 1  # empty blocks
    assert render_results.main([md], device="cpu") == 0
    assert render_results.main([md, "--check"]) == 0
    text = open(md).read()
    assert text.startswith("# title\n\nprose\n\n")
    assert "\n\nmore prose\n\n" in text
    rows = render_results.render_suite(_records(port_json))
    assert rows in text
    edited = text.replace("| gain |", "| gain (edited) |")
    assert edited != text
    with open(md, "w") as f:
        f.write(edited)
    capsys.readouterr()
    assert render_results.main([md, "--check"]) == 1
    assert "generated:suite drifted from R.json" in capsys.readouterr().err
    assert open(md).read() == edited  # --check writes nothing


def test_each_block_names_the_card(port_json, tmp_path):
    recs = _records(port_json)
    for r in recs:
        r["device"] = CARD
    src = tmp_path / "card.json"
    with open(src, "w") as f:
        json.dump(recs, f)
    md = _doc(tmp_path, str(src))
    render_results.main([md])
    text = open(md).read()
    line = "Measured on NVIDIA H100 80GB HBM3, 700.00 W."
    assert text.count(line) == 2
    for section in ("suite", "roofline"):
        body = text.split(f"generated:{section} from R.json -->\n")[1]
        assert body.startswith(line + "\n\n| Benchmark |")


def test_an_unknown_section_raises(port_json, tmp_path):
    shutil.copy(port_json, tmp_path / "R.json")
    md = tmp_path / "P.md"
    md.write_text("<!-- BEGIN generated:projection from R.json -->\n"
                  "<!-- END generated:projection -->\n")
    with pytest.raises(ValueError, match="unknown generated section "
                                         "projection"):
        render_results.process(str(md))


# -- remeasure_rows -----------------------------------------------------------

def test_remeasure_replaces_only_the_named_row(port_json, tmp_path):
    path = str(tmp_path / "suite.json")
    shutil.copy(port_json, path)
    before = _records(path)
    rc, out = _quiet(remeasure_rows.main, [
        path, "gain", "--satReps", "5", "--nRuns", "3",
        "--pipelineDepth", "4"], device="cpu")
    assert rc == 0, out
    assert "remeasure: gain (satReps 5) ..." in out
    after = _records(path)
    assert [r["benchmark"] for r in after] == ["gain", "IIRFilter"]
    assert after[1] == before[1]
    assert json.dumps(after[1], indent=2) == json.dumps(before[1], indent=2)
    gain = after[0]
    assert gain["saturated"]["reps"] == 5
    assert gain["saturated"]["pipeline_depth"] == 4
    assert gain["validation"]["status"] == "SUCCESS"
    assert gain["configuration"]["nRuns"] == 3


def test_remeasure_refuses_a_name_not_in_the_suite(port_json, tmp_path):
    path = str(tmp_path / "suite.json")
    shutil.copy(port_json, path)
    with pytest.raises(SystemExit, match=f"^NoSuch not in {path}$"):
        remeasure_rows.main([path, "NoSuch"], device="cpu")
    assert _records(path) == _records(port_json)


# -- regen_artifacts ----------------------------------------------------------

def test_regen_writes_every_artifact_from_one_run(tmp_path):
    out = str(tmp_path / "art")
    rc, text = _quiet(regen_artifacts.main, [
        "--out", out, "--benchmarkFilter", "/gain|NoOp/", "--nRuns", "3",
        "--pipelineDepth", "4"], device="cpu")
    assert rc == 0, text[-3000:]
    assert sorted(os.listdir(out)) == ["RESULTS.csv", "RESULTS.json",
                                       "RESULTS.md", "report.html"]
    recs = _records(os.path.join(out, "RESULTS.json"))
    assert [r["benchmark"] for r in recs] == ["NoOp", "gain", "GainStats"]
    assert all(r["validation"]["status"] == "SUCCESS" for r in recs)
    assert all(r["configuration"]["nRuns"] == 3 for r in recs)
    assert all(r["saturated"]["pipeline_depth"] == 4 for r in recs)
    with open(os.path.join(out, "RESULTS.csv")) as f:
        assert f.read() == csv_from_json_results(recs)
    md = os.path.join(out, "RESULTS.md")
    assert render_results.main([md, "--check"]) == 0
    text = open(md).read()
    assert render_results.render_suite(recs) in text
    assert "Measured on cpu." in text
    with open(os.path.join(out, "report.html")) as f:
        page = f.read()
    assert all(r["benchmark"] in page for r in recs)

    # A second run re-renders the doc it finds and keeps its prose.
    with open(md, "a") as f:
        f.write("\nA note of the reader's.\n")
    rc, text = _quiet(regen_artifacts.main, [
        "--out", out, "--benchmarkFilter", "/NoOp/", "--nRuns", "3",
        "--pipelineDepth", "4"], device="cpu")
    assert rc == 0
    text = open(md).read()
    assert text.endswith("\nA note of the reader's.\n")
    assert "| GainStats |" not in text
    assert render_results.main([md, "--check"]) == 0


def test_regen_stops_before_replacing_the_json_on_a_failed_run(tmp_path):
    out = str(tmp_path / "art")
    rc, text = _quiet(regen_artifacts.main, [
        "--out", out, "--benchmarkFilter", "/gain/", "--nRuns", "0"],
        device="cpu")
    assert rc == 1
    assert not os.path.exists(os.path.join(out, "RESULTS.json"))
    assert "its JSON is left in" in text


# -- readme_headline ----------------------------------------------------------

BENCH_LINE = {
    "metric": "modal_1M_block_ms", "value": 0.1209, "unit": "ms",
    "vs_baseline": 26.203, "blocks_per_sec_per_chip": 8271.3,
    "saturated_marginal_p50_ms": 0.1181, "validation": "passed",
    "backend": "torch-cuda", "device_name": "NVIDIA H100 80GB HBM3",
    "power_limit": "700.00 W"}


def _readme_copy(tmp_path):
    with open(os.path.join(ROOT, "README.md")) as f:
        original = f.read()
    assert readme_headline.BEGIN not in original
    path = tmp_path / "README.md"
    path.write_text(original + f"\n{readme_headline.BEGIN}\nold text\n"
                    f"{readme_headline.END}\n\ntail\n")
    return original, str(path)


def _artifacts(tmp_path, port_json):
    art = tmp_path / "art"
    art.mkdir()
    (art / "bench.json").write_text("a printed line\n"
                                    + json.dumps(BENCH_LINE) + "\n")
    suite = _records(port_json)
    suite.append({"benchmark": "ModalFilterBank", "device": CARD,
                  "metadata": {"numModes": 1048576, "roofline": {
                      "achieved_gflops": 27500.0, "flops_pct_of_peak": 44.8,
                      "unit": "fp32", "peak_source": "measured"}}})
    (art / "RESULTS.json").write_text(json.dumps(suite))
    (art / "overlap.json").write_text(json.dumps(
        {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
         "rows": [{"name": "gain", "speedup": 1.4},
                  {"name": "IIRFilter", "speedup": 2.25}]}))
    (art / "cap_iir.json").write_text(json.dumps(
        {"benchmark": "IIRFilter", "knob": "n_tracks", "capacity": 458752,
         "bracket": {"certified": 458752, "edge": 475136}}))
    return str(art)


def test_headline_rewrites_only_the_ports_block(tmp_path, port_json):
    original, path = _readme_copy(tmp_path)
    art = _artifacts(tmp_path, port_json)
    rc, out = _quiet(readme_headline.main, [path, "--artifacts", art],
                     device="cpu")
    assert rc == 0 and "regenerated" in out
    text = open(path).read()
    # Everything before the port's block is the README as it was, the
    # JAX block among it, byte for byte.
    assert text.startswith(original)
    jax = original[original.index(JAX_BEGIN):original.index(JAX_END)]
    assert text.count(jax) == 1
    assert text.endswith(f"{readme_headline.END}\n\ntail\n")
    block = text[text.index(readme_headline.BEGIN):]
    assert "old text" not in block
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in block
    assert "**0.1209 ms**" in block and "**26.2× faster**" in block
    assert "**0.1181 ms**" in block
    assert "1,048,576-mode" in block and "45% of the card's FP32" in block
    assert "IIRFilter `n_tracks` **458,752** certified (edge 475,136" in block
    assert "**1.40–2.25×**" in block
    assert _quiet(readme_headline.main,
                  [path, "--artifacts", art, "--check"])[0] == 0
    # The block drifts when an artifact changes.
    (tmp_path / "art" / "overlap.json").write_text(json.dumps(
        {"rows": [{"name": "gain", "speedup": 1.5}]}))
    rc, out = _quiet(readme_headline.main,
                     [path, "--artifacts", art, "--check"])
    assert rc == 1 and "DRIFTED" in out
    assert open(path).read() == text


def test_headline_leaves_out_a_missing_source(tmp_path, port_json):
    _, path = _readme_copy(tmp_path)
    art = tmp_path / "empty"
    art.mkdir()
    assert readme_headline.process(path, str(art)) is True
    block = open(path).read().split(readme_headline.BEGIN)[1]
    assert block.split(readme_headline.END)[0].strip() == (
        "**The PyTorch / CUDA port on card not recorded.**")
    (art / "RESULTS.json").write_text(open(port_json).read())
    assert readme_headline.process(path, str(art)) is True
    assert "The PyTorch / CUDA port on cpu." in open(path).read()


def test_headline_refuses_a_file_without_its_sentinels(tmp_path):
    path = tmp_path / "README.md"
    shutil.copy(os.path.join(ROOT, "README.md"), path)
    before = path.read_text()
    with pytest.raises(ValueError, match="no <!-- torch-headline:begin -->"):
        readme_headline.process(str(path), str(tmp_path))
    rc, out = _quiet(readme_headline.main,
                     [str(path), "--artifacts", str(tmp_path)])
    assert rc == 1 and out.startswith("Error:")
    assert path.read_text() == before
