"""The port's web UI (``gpuaudiobench_tpu_torch/webui``) against the JAX
package's (``gpuaudiobench_tpu/webui``), on the CPU.

* For each ported name, the parameter schemas and the ``apply_params``
  mappings are the reference's, apart from the labels and descriptions,
  which name the card's parts. The device mesh and ``dataParallel`` are
  taken, and more than one rank runs on gloo ranks.
* Over real HTTP against the stdlib server on an ephemeral port, with
  jobs on the CPU (``device="cpu"``): the reference's end-to-end checks,
  a job's phases read from the record its progress hook keeps (not from
  20 ms polls, which race the job), and ``/api/export.csv`` equal to
  ``csv_from_json_results`` of ``/api/export.json``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from gpuaudiobench_tpu.config import BenchConfig as JaxConfig
from gpuaudiobench_tpu.webui import params as ref_params
from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.output import csv_from_json_results
from gpuaudiobench_tpu_torch.registry import ported_benchmarks
from gpuaudiobench_tpu_torch.webui import params
from gpuaudiobench_tpu_torch.webui import server as srv

REF_STATIC = os.path.join(os.path.dirname(ref_params.__file__), "static")
# The keys of a control that must be the reference's; labels and
# descriptions may name the card.
STRUCTURE = ("id", "type", "min", "max", "default", "step", "unit")


def _structure(schema):
    return [({k: p.get(k) for k in STRUCTURE},
             [o["value"] for o in p.get("options", [])]) for p in schema]


def test_global_params_are_the_references():
    ours, theirs = params.global_params(), ref_params.global_params()
    assert _structure(ours) == _structure(theirs)
    impl = next(p for p in ours if p["id"] == "impl")
    labels = " ".join(o["label"] for o in impl["options"])
    assert "CUDA" in labels and "Pallas" not in labels and "TPU" not in labels


@pytest.mark.parametrize("name", ported_benchmarks())
def test_benchmark_params_are_the_references(name):
    assert _structure(params.benchmark_params(name)) == \
        _structure(ref_params.benchmark_params(name))


@pytest.mark.parametrize("name", ported_benchmarks())
def test_apply_params_maps_as_the_reference(name):
    schema = params.global_params() + params.benchmark_params(name)
    values = {p["id"]: p["default"] for p in schema}
    # Move every control off its default, to its last option or its max.
    for p in schema:
        if p["type"] == "select":
            values[p["id"]] = p["options"][-1]["value"]
        elif p["type"] == "slider":
            values[p["id"]] = p["max"]
        else:
            values[p["id"]] = not p["default"]
    values.update(seed=7, fs=44100)
    for pid in ("impl", "iirForm", "iirBlockM"):
        values.pop(pid, None)  # combinations either config may refuse
    ours = params.apply_params(BenchConfig(), values)
    theirs = ref_params.apply_params(JaxConfig(), values)
    for field, _ in params._FIELD_MAP.values():
        assert getattr(ours, field) == getattr(theirs, field), field


def test_field_map_is_the_references_but_item_18():
    """All of the reference's parameters: mesh (item 18a) and, since
    items 18b and 18c, dataParallel too."""
    assert set(ref_params._FIELD_MAP) == set(params._FIELD_MAP)
    for pid, spec in params._FIELD_MAP.items():
        assert ref_params._FIELD_MAP[pid] == spec, pid


@pytest.mark.parametrize("pid,value", [("mesh", "1,1,1"),
                                       ("dataParallel", 1)])
def test_mesh_and_data_parallel_are_refused_naming_item_18(pid, value):
    """Both are taken now: dataParallel (items 18b and 18c) as the
    reference maps it; mesh (item 18a), offered for the multichip
    benchmarks, as the reference offers it."""
    if pid == "dataParallel":
        for v in (value, 4):
            ours = params.apply_params(BenchConfig(), {pid: v})
            theirs = ref_params.apply_params(JaxConfig(), {pid: v})
            assert ours.data_parallel == theirs.data_parallel == v
        return
    assert params.apply_params(BenchConfig(), {pid: "2,2,1"}).mesh == "2,2,1"
    for name in ("MultiChipSuite", "ICIBandwidth"):
        assert params.benchmark_params(name) == \
            ref_params.benchmark_params(name)
        assert [p["id"] for p in params.benchmark_params(name)] == ["mesh"]


def test_apply_params_rejects_unknown_and_invalid():
    with pytest.raises(ValueError, match="unknown parameter"):
        params.apply_params(BenchConfig(), {"nope": 1})
    with pytest.raises(ValueError, match="invalid value"):
        params.apply_params(BenchConfig(), {"bufferSize": "abc"})
    with pytest.raises(ValueError):
        params.apply_params(BenchConfig(), {"verification": "bogus"})
    assert params.apply_params(BenchConfig(), {"modalModes": 0}) \
        .modal_num_modes is None
    out = params.apply_params(BenchConfig(), {"dawsim": "true",
                                              "fdtdPerTrackReceivers": True})
    assert out.dawsim is True and out.fdtd_per_track_receivers is True


def test_serve_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        srv.serve(port=0)


# ---------------------------------------------------------------------------
# HTTP server end to end (jobs on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ui_server(tmp_path_factory):
    presets = tmp_path_factory.mktemp("webui") / "presets.json"
    httpd = srv.serve(port=0, presets_path=str(presets), device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.job_runner.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.headers.get("Content-Type", ""), r.read()


def _get_json(base, path):
    ctype, body = _get(base, path)
    assert "json" in ctype
    return json.loads(body)


def _post_json(base, path, obj, expect_ok=True, headers=None):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(), method="POST",
        headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        if expect_ok:
            raise
        return e.code, json.loads(e.read())


def _wait_job(base, job_id, timeout=300.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        job = _get_json(base, f"/api/job?id={job_id}")
        if job["status"] in ("done", "error"):
            return job
        time.sleep(0.3)
    raise TimeoutError("job did not finish")


SMALL = {"bufferSize": 64, "nTracks": 8, "nRuns": 3, "warmup": 1,
         "deviceTiming": False}


def test_index_served(ui_server):
    ctype, body = _get(ui_server, "/")
    assert "text/html" in ctype
    assert b"GPU Audio Benchmarks" in body and b"TPU" not in body
    assert b"src=\"http" not in body and b"href=\"http" not in body


def test_hardware_endpoint(ui_server):
    hw = _get_json(ui_server, "/api/hardware")
    assert hw["platform"] == "cpu" and hw["device_kind"] == "cpu"
    assert hw["framework"] == "pytorch"
    assert hw["torch_version"] == torch.__version__


def test_benchmarks_catalog(ui_server):
    cat = _get_json(ui_server, "/api/benchmarks")
    names = [b["name"] for b in cat["benchmarks"]]
    assert names == ported_benchmarks()
    assert "dsp" in cat["categories"] and "multichip" in cat["categories"]
    conv = next(b for b in cat["benchmarks"] if b["name"] == "Conv1D")
    assert any(p["id"] == "irLength" for p in conv["params"])
    assert any(p["id"] == "bufferSize" for p in cat["global_params"])


def test_run_single_benchmark_with_its_phases(ui_server):
    code, resp = _post_json(ui_server, "/api/run",
                            {"benchmarks": ["gain"],
                             "params": dict(SMALL, pipelineDepth=8)})
    assert code == 202
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done" and job["errors"] == []
    (res,) = job["results"]
    assert res["benchmark"] == "gain"
    assert res["validation"]["status"] == "SUCCESS"
    assert res["statistics"]["p50_ms"] > 0
    assert len(res["raw_latencies_ms"]) == 3
    # Every phase, in order, from the runner's progress hook.
    assert job["phases"] == ["gain:setup", "gain:warmup", "gain:timed",
                             "gain:saturated", "gain:validate"]
    assert job["phase"] is None  # cleared at completion


def test_run_with_benchmark_params(ui_server):
    params_ = dict(SMALL, irLength=128, convEdgeMode="clamp")
    code, resp = _post_json(ui_server, "/api/run",
                            {"benchmarks": ["Conv1D"], "params": params_})
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done", job["errors"]
    assert job["results"][0]["validation"]["status"] == "SUCCESS"
    assert job["results"][0]["metadata"]["irLength"] == 128


def test_run_category_suite_with_progress(ui_server):
    code, resp = _post_json(ui_server, "/api/run",
                            {"category": "basic", "params": SMALL})
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done"
    assert job["total"] == 3 and job["completed"] == 3
    assert {r["benchmark"] for r in job["results"]} == {
        "NoOp", "gain", "GainStats"}
    assert [p for p in job["phases"] if p.endswith(":setup")] == [
        "NoOp:setup", "gain:setup", "GainStats:setup"]


def test_run_rejects_bad_requests(ui_server):
    code, resp = _post_json(ui_server, "/api/run", {}, expect_ok=False)
    assert code == 400
    code, resp = _post_json(ui_server, "/api/run",
                            {"benchmarks": ["NotABenchmark"]},
                            expect_ok=False)
    assert code == 400 and "NotABenchmark" in resp["error"]
    code, resp = _post_json(ui_server, "/api/run",
                            {"benchmarks": ["gain"],
                             "params": {"bogusParam": 1}}, expect_ok=False)
    assert code == 400 and "bogusParam" in resp["error"]
    code, resp = _post_json(ui_server, "/api/run", {"category": "nope"},
                            expect_ok=False)
    assert code == 400


@pytest.mark.parametrize("body", [
    {"benchmarks": ["MultiChipSuite", "gain"],
     "params": dict(SMALL, mesh="2,1,1")},
    {"category": "multichip", "params": dict(SMALL, transferMiB=1)},
    {"benchmarks": ["gain"], "params": dict(SMALL, mesh="1,1,1")},
    {"benchmarks": ["gain"], "params": dict(SMALL, dataParallel=2)},
])
def test_unported_requests_are_refused_naming_item_18(ui_server, body):
    """Nothing of item 18 is refused now. The multichip benchmarks and
    the mesh run (item 18a), and dataParallel (items 18b and 18c): a mesh
    of 2 ranks, or gain over 2 data-parallel ranks, as the CLI runs it,
    on gloo ranks."""
    code, resp = _post_json(ui_server, "/api/run", body, expect_ok=False)
    assert code == 202, resp
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done" and job["errors"] == [], job["errors"]
    names = body.get("benchmarks") or ["MultiChipSuite", "ICIBandwidth"]
    assert [r["benchmark"] for r in job["results"]] == names
    for r in job["results"]:
        assert r["validation"]["status"] == "SUCCESS"
        if r["benchmark"] == "MultiChipSuite":
            mesh = body["params"].get("mesh", "1,1,1")
            assert r["metadata"]["mesh"] == dict(
                zip(("dp", "tp", "sp"), map(int, mesh.split(","))))


def test_presets_roundtrip(ui_server):
    _post_json(ui_server, "/api/presets",
               {"benchmark": "Conv1D", "name": "long-ir",
                "params": {"irLength": 2048}})
    presets = _get_json(ui_server, "/api/presets")
    assert presets["Conv1D"]["long-ir"]["irLength"] == 2048
    code, resp = _post_json(ui_server, "/api/presets",
                            {"action": "delete", "benchmark": "Conv1D",
                             "name": "long-ir"})
    assert resp["ok"] is True
    assert "Conv1D" not in _get_json(ui_server, "/api/presets")


def test_session_export_is_the_harness_csv(ui_server):
    code, resp = _post_json(ui_server, "/api/run",
                            {"benchmarks": ["gain"], "params": SMALL})
    _wait_job(ui_server, resp["job_id"])
    data = _get_json(ui_server, "/api/export.json")
    assert any(r["benchmark"] == "gain" for r in data["results"])
    ctype, body = _get(ui_server, "/api/export.csv")
    assert "csv" in ctype
    assert body.decode() == csv_from_json_results(data["results"])
    lines = body.decode().strip().splitlines()
    assert lines[0].startswith("benchmark,fs,bufferSize")
    assert len(lines) >= 2


def test_unknown_routes_404(ui_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(ui_server, "/api/nope")
    assert e.value.code == 404


def test_compare_endpoint(ui_server):
    data = _get_json(ui_server, "/api/compare")
    assert data["published"]["ModalFilterBank"]["PC"][0] == 3.168
    assert 1048576 in {int(k) for k in data["modal_sweep"]}


def test_jobs_queue_serially(ui_server):
    ids = []
    for _ in range(2):
        code, resp = _post_json(ui_server, "/api/run",
                                {"benchmarks": ["NoOp"], "params": SMALL})
        assert code == 202
        ids.append(resp["job_id"])
    jobs = [_wait_job(ui_server, i) for i in ids]
    assert all(j["status"] == "done" and not j["errors"] for j in jobs)
    listing = _get_json(ui_server, "/api/jobs")["jobs"]
    assert set(ids) <= {j["id"] for j in listing}


def test_suite_run_applies_benchmark_overrides(ui_server):
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["Conv1D", "gain"], "params": SMALL,
         "benchmark_params": {"Conv1D": {"irLength": 192}}})
    assert code == 202
    job = _wait_job(ui_server, resp["job_id"])
    assert job["status"] == "done", job["errors"]
    conv = next(r for r in job["results"] if r["benchmark"] == "Conv1D")
    assert conv["metadata"]["irLength"] == 192
    code, resp = _post_json(
        ui_server, "/api/run",
        {"benchmarks": ["Conv1D"], "params": SMALL,
         "benchmark_params": {"Conv1D": {"nope": 1}}}, expect_ok=False)
    assert code == 400


def test_post_cross_origin_guard(ui_server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(ui_server, "/api/run", {"benchmarks": ["NoOp"]},
                   headers={"Content-Type": "text/plain"})
    assert ei.value.code == 415
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(ui_server, "/api/presets",
                   {"benchmark": "gain", "name": "x"},
                   headers={"Content-Type": "application/json",
                            "Host": "attacker.example"})
    assert ei.value.code == 403
    assert _get_json(ui_server, "/api/jobs") is not None


def test_mesh_job_reports_its_phases_and_never_stalls():
    """A job of gain over 2 data-parallel gloo ranks: rank 0's phases
    reach the job thread as they happen, so ``phases`` runs from setup to
    validate in order, as the one-rank job's do, a phase after setup shows
    while the job runs, and no poll reports it stalled (the threshold cut
    to 20 s, beyond any quiet stretch of this job)."""
    r = srv.JobRunner(torch.device("cpu"))
    r.STALL_AFTER_S = 20
    try:
        job_id = r.submit(["gain"], dict(SMALL, pipelineDepth=8,
                                         dataParallel=2))
        deadline = time.time() + 300
        running_phases = set()
        while True:
            job = r.get(job_id)
            assert "stalled_seconds" not in job
            assert "stalled_seconds" not in {
                j["id"]: j for j in r.list_jobs()}[job_id]
            if job["status"] == "running":
                running_phases.add(job["phase"])
            if job["status"] in ("done", "error"):
                break
            assert time.time() < deadline, "job did not finish"
            time.sleep(0.05)
        assert job["status"] == "done" and job["errors"] == []
        (res,) = job["results"]
        assert res["validation"]["status"] == "SUCCESS"
        assert job["phases"] == ["gain:setup", "gain:warmup", "gain:timed",
                                 "gain:saturated", "gain:validate"]
        assert running_phases - {None, "setup"}
    finally:
        r.shutdown()


def test_running_job_reports_stall():
    r = srv.JobRunner(torch.device("cpu"))
    try:
        with r._lock:
            r.jobs["stuck1"] = {
                "id": "stuck1", "status": "running",
                "benchmarks": ["gain"], "completed": 0, "total": 1,
                "current": "gain", "phase": "device-timing", "phases": [],
                "results": [], "errors": [],
                "submitted_at": time.time() - 1000,
                "phase_at": time.time() - 1000,
            }
        assert r.get("stuck1")["stalled_seconds"] >= 900
        assert {j["id"]: j for j in r.list_jobs()}["stuck1"][
            "stalled_seconds"] >= 900
        with r._lock:
            r.jobs["stuck1"]["phase_at"] = time.time()
        assert "stalled_seconds" not in r.get("stuck1")
        with r._lock:
            r.jobs["stuck1"]["status"] = "done"
            r.jobs["stuck1"]["phase_at"] = time.time() - 1000
        assert "stalled_seconds" not in r.get("stuck1")
    finally:
        r.shutdown()


def _script(name):
    html = open(os.path.join(name, "index.html")).read()
    return html, re.search(r"<script>(.*)</script>", html, re.S).group(1)


def test_index_html_is_the_references_script_with_the_ports_text():
    html, script = _script(srv.STATIC_DIR)
    ref_html, ref_script = _script(REF_STATIC)
    assert script.replace('"gpuab-torch-', '"tpuab-') == ref_script
    looked_up = set(re.findall(r'\$\("([\w-]+)"\)', script))
    looked_up |= set(re.findall(r'getElementById\("([\w-]+)"\)', script))
    declared = set(re.findall(r'id="([\w-]+)"', html))
    assert {i for i in looked_up if i not in declared
            and not i.startswith("chart-")} == set()
    assert set(re.findall(r'id="([\w-]+)"', ref_html)) == declared
