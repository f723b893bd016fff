"""MultiChipSuite and ICIBandwidth through the port's CLI
(``main(argv, device="cpu")``) at meshes of 1 and 8 ranks, against
the JAX CLI's JSON on the conftest's 8-device CPU mesh: every run
validates, the JSON keys are the reference's but the documented ones,
the collective inventory of a step is the reference's by kind and bytes,
and ``--dataParallel`` runs, but not on these two, which refuse it. A mesh of
more than one rank spawns gloo ranks (``parallel/launch.py:spmd``: one
spawn a ``main`` run, its timeout ``cli.SPMD_TIMEOUT_S``; the batched
launch's ``SPAWN_TIMEOUT_S``).
"""

import contextlib
import io
import json

import pytest

from gpuaudiobench_tpu import cli as jax_cli
from gpuaudiobench_tpu.parallel.ici_model import suite_collectives
from gpuaudiobench_tpu_torch import cli
from gpuaudiobench_tpu_torch.parallel import ranks
from gpuaudiobench_tpu_torch.parallel.launch import spmd
from gpuaudiobench_tpu_torch.parallel.mesh import AXES

SPAWN_TIMEOUT_S = 180

CLI_TOY = ["--nTracks", "8", "--bufferSize", "64", "--nRuns", "3",
           "--warmup", "1", "--pipelineDepth", "8", "--saturatedReps", "3",
           "--transferMiB", "1", "--json"]


def _by_kind(records):
    out = {}
    for r in records:
        k = out.setdefault(r["kind"], [0, 0])
        k[0] += 1
        k[1] += r["bytes"]
    return out


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue().splitlines()


def _json(lines):
    start = next(i for i, ln in enumerate(lines) if ln in ("{", "["))
    close = "}" if lines[start] == "{" else "]"
    end = len(lines) - 1 - lines[::-1].index(close)
    rec = json.loads("\n".join(lines[start:end + 1]))
    return rec if isinstance(rec, list) else [rec]


def _paths(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "ici_model":
            out |= _paths(v, prefix + k + ".")
    return out


# The port's keys the JAX CLI's JSON lacks, and the reverse (ROADMAP.md
# §3): the chain form; the collectives one step issued in place of the
# model of the TPU interconnect (on a mesh of more than one rank).
PORT_ONLY = {"metadata.chainForm", "metadata.collectiveInventory"}
JAX_ONLY = {"metadata.ici_model"}


@pytest.fixture(scope="module")
def cli_runs():
    """--category multichip through the port's CLI at 1,1,1 (in this
    process) and 2,2,2 (``main`` spawns 8 gloo ranks); then, in one more
    launch of 8 ranks, the same category at 8,1,1 and MultiChipSuite at
    1,1,8 through the CLI's rank path (``cli.rank_run``, what ``main``
    runs on each rank): {mesh: (exit code, output lines)}."""
    out = {}
    for mesh in ("1,1,1", "2,2,2"):
        out[mesh] = _run(cli.main, ["--category", "multichip", "--mesh", mesh]
                         + CLI_TOY, device="cpu")
    batch = {"8,1,1": ["--category", "multichip"],
             "1,1,8": ["--benchmark", "MultiChipSuite"]}
    res = spmd(ranks.cli_runs, 8, "cpu",
               [argv + ["--mesh", mesh] + CLI_TOY
                for mesh, argv in batch.items()], "cpu",
               timeout_s=SPAWN_TIMEOUT_S)
    for mesh, (rc, text) in zip(batch, res):
        out[mesh] = (rc, text.splitlines())
    return out


@pytest.mark.parametrize("mesh", ["1,1,1", "2,2,2", "8,1,1", "1,1,8"])
def test_cli_runs_and_validates_on_every_mesh(cli_runs, mesh):
    rc, lines = cli_runs[mesh]
    assert rc == 0, lines[-30:]
    recs = _json(lines)
    want = (["MultiChipSuite"] if mesh == "1,1,8"
            else ["MultiChipSuite", "ICIBandwidth"])
    assert [r["benchmark"] for r in recs] == want
    dp, tp, sp = map(int, mesh.split(","))
    n = dp * tp * sp
    for r in recs:
        assert r["validation"]["status"] == "SUCCESS", r["validation"]
        assert r["metadata"]["chainForm"] == "loop"
        talks = (tp * sp if r["benchmark"] == "MultiChipSuite" else n) > 1
        assert bool(r["metadata"]["collectiveInventory"]) == talks
    suite = recs[0]["metadata"]
    assert suite["mesh"] == dict(zip(AXES, map(int, mesh.split(","))))
    if n > 1:
        assert lines[0] == f"SPMD: {n} ranks over gloo, mesh {mesh}"
    else:
        assert not any(ln.startswith("SPMD") for ln in lines)


def test_cli_json_keys_are_the_references(cli_runs):
    """Key for key the JAX CLI's at --mesh 2,2,2, but the documented
    ones; the configuration, mesh and shapes equal."""
    _, lines = cli_runs["2,2,2"]
    ours = _json(lines)
    rc, jlines = _run(lambda a: jax_cli.main(a), ["--category", "multichip",
                                                  "--mesh", "2,2,2"]
                      + CLI_TOY)
    assert rc == 0
    theirs = _json(jlines)
    for o, t in zip(ours, theirs):
        assert o["benchmark"] == t["benchmark"]
        o.pop("saturated", None)  # asked of the port only
        t.pop("saturated", None)
        assert _paths(o) - PORT_ONLY == _paths(t) - JAX_ONLY, o["benchmark"]
        assert o["configuration"] == t["configuration"]
        for k in ("mesh", "modes", "tracks", "samples", "devices",
                  "chunkMiB", "collectives"):
            assert o["metadata"].get(k) == t["metadata"].get(k), k


def test_cli_inventory_is_the_step_inventory(cli_runs):
    """MultiChipSuite's collectiveInventory at 2,2,2 holds the kinds and
    bytes of suite_collectives for its trimmed shapes; ICIBandwidth's the
    ring and the scalar psum."""
    suite, ici = _json(cli_runs["2,2,2"][1])
    md = suite["metadata"]
    ir_len = max(3, min(33, md["samples"] // 2))  # the set-up's clamp
    inv = suite_collectives(md["tracks"] // 2, md["samples"], sp=2, tp=2,
                            ir_len=ir_len)
    want = {}
    for c in inv:
        k = want.setdefault(c["kind"], [0, 0])
        k[0] += 2 if "pp handoffs" in c["label"] else 1
        k[1] += c["bytes"]
    assert _by_kind(md["collectiveInventory"]) == want
    got = [(c["kind"], c["axis_n"], c["bytes"])
           for c in ici["metadata"]["collectiveInventory"]]
    assert got == [("ppermute", 8, 1024 * 1024), ("psum", 8, 4)]


def test_data_parallel_is_refused_naming_item_18b():
    """--dataParallel was refused naming ROADMAP item 18b until it was
    ported. Now the run goes over 2 gloo ranks: gain validates on them,
    and MultiChipSuite refuses the flag with its own message (its
    parallelism is --mesh), so the run exits 1."""
    rc, lines = _run(cli.main, ["--benchmarkFilter", "=MultiChipSuite,=gain",
                                "--dataParallel", "2"] + CLI_TOY,
                     device="cpu")
    assert rc == 1
    assert lines[0] == "SPMD: 2 ranks over gloo, dataParallel 2"
    assert ("Benchmark MultiChipSuite failed: ValueError: MultiChipSuite "
            "parallelism is set with --mesh dp,tp,sp, not --dataParallel"
            ) in lines
    [gain] = _json(lines)
    assert gain["benchmark"] == "gain"
    assert gain["validation"]["status"] == "SUCCESS"
    assert gain["metadata"]["collectiveInventory"] == []
