"""The port's attribution and campaign tools on the CPU at toy sizes,
held to the JAX package's tools: ``tools/latency_attrib`` (the depth
sweep's fit, its columns and the device p50), ``tools/overlap_campaign``
(which names run and which are skipped) and ``tools/mesh_scaling`` (the
ladder on gloo ranks, the collectives a step issued against the JAX
package's ``ici_model`` on the conftest's 8-device CPU mesh)."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.harness.base import Benchmark as JaxBenchmark
from gpuaudiobench_tpu.harness.runner import run_benchmark as jax_run
from gpuaudiobench_tpu.registry import create_benchmark as jax_create
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.tools import (
    latency_attrib,
    mesh_scaling,
    overlap_campaign,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _root_tool(name):
    """A repo-level tool of the JAX package, loaded by path (each imports
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


def _payload(base):
    with open(base + ".json") as f:
        payload = json.load(f)
    with open(base + ".md") as f:
        return payload, f.read()


def _header(md):
    line = next(ln for ln in md.splitlines() if ln.startswith("| Benchmark"))
    return [c.strip() for c in line.strip("|").split("|")]


# -- latency_attrib -----------------------------------------------------------

def test_the_lists_are_the_jax_tools():
    root = _root_tool("latency_attrib")
    assert latency_attrib.DEPTHS == root.DEPTHS
    assert latency_attrib.WORKLOADS == root.WORKLOADS
    root = _root_tool("overlap_campaign")
    assert overlap_campaign.BENCHES == root.BENCHES
    root = _root_tool("mesh_scaling")
    assert mesh_scaling.SUITE_MESHES == root.SUITE_MESHES
    assert mesh_scaling.ICI_MESHES == root.ICI_MESHES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_line_is_the_jax_tools_exactly(seed):
    root = _root_tool("latency_attrib")
    rng = np.random.default_rng(seed)
    xs = [int(x) for x in sorted(rng.choice(600, size=5, replace=False) + 1)]
    ys = [float(3.0 + 0.01 * x + rng.normal(0, 0.2)) for x in xs]
    assert latency_attrib.fit_line(xs, ys) == root.fit_line(xs, ys)
    a, b = latency_attrib.fit_line([16, 64, 128], [1.16, 1.64, 2.28])
    assert a == pytest.approx(1.0) and b == pytest.approx(0.01)


@pytest.fixture(scope="module")
def attrib(tmp_path_factory):
    """Both tools over two depths and two workloads: the port's payload
    and markdown, and the JAX tool's markdown."""
    tmp = tmp_path_factory.mktemp("attrib")
    mp = pytest.MonkeyPatch()
    root = _root_tool("latency_attrib")
    for mod in (latency_attrib, root):
        mp.setattr(mod, "DEPTHS", [2, 4, 8])
        mp.setattr(mod, "WORKLOADS", ["NoOp", "gain"])
    try:
        base = str(tmp / "port")
        rc, _ = _quiet(latency_attrib.main, [base + ".md", "--reps", "3"],
                       device="cpu")
        assert rc == 0
        assert _quiet(root.main, [str(tmp / "jax.md"), "--reps", "2"])[0] == 0
    finally:
        mp.undo()
    payload, md = _payload(base)
    with open(tmp / "jax.md") as f:
        return payload, md, f.read()


def test_latency_attrib_has_the_jax_columns_and_the_device_p50(attrib):
    payload, md, jax_md = attrib
    ours, theirs = _header(md), _header(jax_md)
    assert [c for c in ours if c in theirs] == theirs
    assert set(ours) - set(theirs) == {"device p50 (ms) [method]", "chain"}
    assert ours.index("device p50 (ms) [method]") == ours.index(
        "B: marginal/block (ms)") + 1
    assert [r["benchmark"] for r in payload["rows"]] == ["NoOp", "gain"]
    assert payload["depths"] == [2, 4, 8] and payload["card"] == "cpu"
    for r in payload["rows"]:
        assert np.isfinite([r["A_ms"], r["B_ms"], r["device_p50_ms"]]).all()
        assert r["device_p50_ms"] > 0
        assert r["device_method"] == "wall"
        assert r["chain_form"] == "loop"
        assert [d for d, _ in r["points"]] == [2, 4, 8]
        a, b = latency_attrib.fit_line([2, 4, 8], [w for _, w in r["points"]])
        assert (a, b) == (r["A_ms"], r["B_ms"])
        row = next(ln for ln in md.splitlines()
                   if ln.startswith(f"| {r['benchmark']} |"))
        assert f"{r['device_p50_ms']:.5f} [wall]" in row
    assert "relay" not in md.lower()
    assert "CUDA graph replay" in md


# -- overlap_campaign ---------------------------------------------------------

def test_overlap_campaign_runs_and_skips_the_jax_tools_names(tmp_path):
    names = "gain,IIRFilter,NoOp"
    base = str(tmp_path / "port")
    rc, out = _quiet(overlap_campaign.main, [
        base + ".md", "--depth", "4", "--reps", "2", "--benches", names],
        device="cpu")
    assert rc == 0, out
    payload, md = _payload(base)
    root = _root_tool("overlap_campaign")
    rc, jax_out = _quiet(root.main, [str(tmp_path / "jax.md"), "--depth",
                                     "4", "--reps", "2", "--benches", names])
    assert rc == 0
    with open(tmp_path / "jax.json") as f:
        jax_rows = json.load(f)
    assert [r["name"] for r in payload["rows"]] == list(jax_rows)
    assert payload["skipped"] == [n for n in names.split(",")
                                  if n not in jax_rows]
    assert payload["skipped"] == ["NoOp"]
    for name in payload["skipped"]:
        line = f"{name}: no overlap body (skipped)"
        assert line in out and line in jax_out
    for r in payload["rows"]:
        assert r["validation"] == "passed"
        assert r["speedup"] == pytest.approx(r["serial"] / r["overlapped"])
        assert r["overlap"]["depth"] == 4 and r["overlap"]["reps"] == 2
    assert _header(md) == ["Benchmark", "serial ms/block",
                           "overlapped ms/block", "speedup", "device timing",
                           "h2d path", "validation"]
    assert md.startswith("# Overlapped-infeed campaign") and " on cpu" in md


def test_every_campaign_name_has_the_jax_packages_overlap_body():
    """The campaign's 13 names run the overlap tier in both packages:
    RndMemRead's body (its playheads uploaded a block ahead) among them."""
    for name in overlap_campaign.BENCHES:
        theirs = type(jax_create(name, JaxConfig()))
        ours = type(create_benchmark(name, BenchConfig(), CPU))
        assert theirs.overlap_body is not JaxBenchmark.overlap_body, name
        assert ours.overlap_body is not Benchmark.overlap_body, name


def test_rndmem_overlap_body_is_the_jax_packages():
    """The same two playhead blocks, and the same gathers of them."""
    knobs = dict(n_tracks=8, buffer_size=64, rndmem_pool_mb=8,
                 device_timing=False, write_latencies=False)
    ref = jax_create("RndMemRead", JaxConfig(**knobs))
    ref.setup()
    b = create_benchmark("RndMemRead", BenchConfig(**knobs), CPU)
    b.setup()
    f, jblocks, _ = ref.overlap_body()
    step, blocks, carry = b.overlap_body()
    assert carry == ()
    assert len(blocks) == len(jblocks) == 2
    for ours, theirs in zip(blocks, jblocks):
        np.testing.assert_array_equal(ours, theirs)
        y, _ = step(torch.from_numpy(ours), ())
        jy, _ = f(np.asarray(theirs), ())
        np.testing.assert_array_equal(y.numpy().ravel(),
                                      np.asarray(jy).ravel())
    assert not np.array_equal(blocks[0], blocks[1])


def test_overlap_campaign_names_the_upload_path(tmp_path):
    base = str(tmp_path / "dc")
    rc, _ = _quiet(overlap_campaign.main, [
        base + ".md", "--depth", "4", "--reps", "2", "--benches",
        "datacopy0199"], device="cpu")
    assert rc == 0
    payload, md = _payload(base)
    [row] = payload["rows"]
    assert row["h2d_path"] == "pageable"  # no pinned memory on the CPU
    assert "| datacopy0199 |" in md and "| pageable |" in md


# -- mesh_scaling -------------------------------------------------------------

LADDER = (["1,1,1", "2,1,1", "2,2,2"], ["1,1,1", "2,1,1"])


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh_scaling, "SUITE_MESHES", LADDER[0])
    mp.setattr(mesh_scaling, "ICI_MESHES", LADDER[1])
    base = str(tmp_path_factory.mktemp("mesh") / "mesh")
    try:
        rc, out = _quiet(mesh_scaling.main, [base + ".md"], device="cpu")
    finally:
        mp.undo()
    assert rc == 0, out
    return _payload(base)


def test_mesh_ladder_validates_every_row_on_gloo(ladder):
    payload, md = ladder
    want = ([("MultiChipSuite", m) for m in LADDER[0]]
            + [("ICIBandwidth", m) for m in LADDER[1]])
    assert [(r["benchmark"], r["mesh"]) for r in payload["rows"]] == want
    assert all(r["validation"] == "passed" for r in payload["rows"])
    assert payload["skipped"] == []
    assert payload["backend"] == "gloo" and payload["devices"] == 8
    assert _header(md) == ["Benchmark", "mesh dp,tp,sp", "p50 ms",
                           "collectives", "validation"]
    assert "v5e" not in md


def test_mesh_ladder_skips_what_the_devices_cannot_hold(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(mesh_scaling, "SUITE_MESHES", ["1,1,1", "4,4,1"])
    monkeypatch.setattr(mesh_scaling, "ICI_MESHES", ["1,1,16"])
    base = str(tmp_path / "m")
    rc, out = _quiet(mesh_scaling.main, [base + ".md"], device="cpu")
    assert rc == 0
    payload, md = _payload(base)
    assert [(r["benchmark"], r["mesh"]) for r in payload["rows"]] == [
        ("MultiChipSuite", "1,1,1")]
    assert payload["skipped"] == [
        "MultiChipSuite 4,4,1: skipped, needs 16 devices; 8 available",
        "ICIBandwidth 1,1,16: skipped, needs 16 devices; 8 available"]
    for line in payload["skipped"]:
        assert line in out and f"- {line}" in md


def _jax_collectives(name, mesh):
    cfg = JaxConfig(buffer_size=256, n_tracks=32, n_runs=5, warmup=2,
                    transfer_mib=1, mesh=mesh, write_latencies=False,
                    device_timing=False)
    b = jax_create(name, cfg)
    b.setup()
    r = jax_run(b, cfg, verbose=False)
    assert r.validation is None or r.validation.passed
    return ((r.metadata or {}).get("ici_model") or {}).get("collectives", [])


def _by_kind(records):
    out = {}
    for c in records:
        k = out.setdefault(c["kind"], [0, 0])
        k[0] += 1
        k[1] += c["bytes"]
    return out


@pytest.mark.parametrize("case", [("MultiChipSuite", m) for m in LADDER[0]]
                         + [("ICIBandwidth", m) for m in LADDER[1]],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_mesh_collectives_are_the_jax_models_kinds(ladder, case):
    """Kind for kind the collectives of the JAX package's ``ici_model`` on
    the same mesh: the same kinds, and the same calls and bytes of every
    kind but the pipeline's ppermute hand-offs, which the port issues
    n_micro + tp - 2 times where the model counts n_micro * (tp - 1) hops
    (ROADMAP §3); ICIBandwidth's scalar psum is 4 bytes, the model's 4 a
    rank."""
    payload, _ = ladder
    row = next(r for r in payload["rows"]
               if (r["benchmark"], r["mesh"]) == case)
    ours, theirs = row["inventory"], _jax_collectives(*case)
    assert {c["kind"] for c in ours} == {c["kind"] for c in theirs}
    got, want = _by_kind(ours), _by_kind(theirs)
    if case[0] == "ICIBandwidth" and theirs:
        n = int(np.prod([int(p) for p in case[1].split(",")]))
        want["psum"][1] //= n
    handoffs = [c for c in theirs if "pp handoffs" in c.get("label", "")]
    if handoffs:
        assert got["ppermute"][0] > want["ppermute"][0] - len(handoffs)
        halo = [c["bytes"] for c in theirs if c["kind"] == "ppermute"
                and c not in handoffs]
        assert all(b in [c["bytes"] for c in ours] for b in halo)
        got.pop("ppermute")
        want.pop("ppermute")
    assert got == want
    if not theirs:
        assert row["collectives"] == "—"
