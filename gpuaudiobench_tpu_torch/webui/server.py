"""Local HTTP server for the interactive benchmark runner.

PyTorch counterpart of ``gpuaudiobench_tpu/webui/server.py``, the
runtime half of the WebGPU app analog (webgpu/js/app.js:26-175
WebGPUBenchmarkApp): on a headless GPU host the front end talks JSON to
this server, which wraps the exact harness the port's CLI uses
(``registry.create_benchmark`` + ``harness.runner.run_benchmark``), so
UI runs and CLI runs are the same measurement.

Design points:
  * stdlib only (http.server): a GPU host may have no egress.
  * One worker thread owns the device (the card unless the server is
    started with ``--device cpu``). Jobs (single benchmark or a category
    suite) queue; /api/job reports per-suite progress the way app.js's
    suite-progress-bar does (webgpu/index.html:169-171), and each job
    keeps the phases its runs went through (``phases``, from the
    runner's ``progress_cb``).
  * No handler thread calls CUDA: the hardware panel is read once, when
    the server is built. While the job thread captures a CUDA graph
    (the saturated tier), an unsafe CUDA call from another thread would
    invalidate the capture.
  * Only ported benchmarks are offered; a run naming another is refused
    with the ROADMAP.md item that ports it. A ``mesh`` or a
    ``dataParallel`` of more than one rank runs the benchmark as the CLI
    does (``cli.mesh_ranks``, ``cli.rank_json`` under
    ``parallel/launch.py:spmd``, from a helper thread that only waits for
    the ranks); rank 0 puts each phase on a queue
    (``cli.RankZeroPhases``), and the job thread records them as they
    come, so a mesh job reports every phase and reads as live to the
    stall check.
  * Presets persist server-side as JSON (the localStorage analog,
    app.js:831-872) so they survive across browsers/machines.
  * Results accumulate per session and export as the harness's own
    CSV/JSON schemas.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.registry import (
    BENCHMARK_DESCRIPTIONS,
    CATEGORIES,
    UNPORTED_BENCHMARKS,
    list_benchmarks,
    ported_benchmarks,
)
from gpuaudiobench_tpu_torch.webui.params import (
    apply_params,
    benchmark_params,
    global_params,
)

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")
DEFAULT_PRESETS_PATH = os.path.expanduser("~/.tpuaudiobench/presets.json")


def published_baselines() -> Dict[str, Any]:
    """Published RTX 4070 / M2 Pro numbers for the comparison column
    (analysis/compare.py tables via the shared loader)."""
    from gpuaudiobench_tpu_torch.utils.published import published_tables

    return published_tables()


def hardware_info(device: torch.device) -> Dict[str, Any]:
    """Device identity panel (webgpu/index.html:55-96 hardware-info:
    vendor/architecture/limits): torch's identity of ``device`` (name,
    compute capability, memory, SM count) and the power limit of the
    port's JSON ``device`` section. Called once, when the server is
    built."""
    from gpuaudiobench_tpu_torch.harness.output import device_identity

    ident = device_identity(device)
    info: Dict[str, Any] = {
        "framework": "pytorch",
        "platform": ident["platform"],
        "device_kind": ident["kind"],
        "num_devices": (torch.cuda.device_count()
                        if device.type == "cuda" else 1),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        info.update({
            "compute_capability": f"{props.major}.{props.minor}",
            "multiprocessor_count": props.multi_processor_count,
            "power_limit": ident["power_limit"],
            "memory_stats": {"bytes_limit": int(props.total_memory)},
        })
    return info


class JobRunner:
    """Single worker thread; serializes all device access.

    Completed jobs are pruned beyond ``MAX_JOBS`` (their result
    payloads duplicate the session accumulator) so a long-lived server
    does not grow without bound."""

    MAX_JOBS = 50
    MAX_RESULTS = 500  # session accumulator cap (drop-oldest)
    # A running job whose phase hasn't advanced for this long is
    # reported as stalled. A wedged device call (a hung kernel) cannot
    # be interrupted from a Python thread -- the honest move is to say
    # so in /api/job instead of looking dead. Phases are stage
    # boundaries and a legitimate tier (a deep saturated pass, a host
    # golden) can take minutes, so the threshold is deliberately lax
    # (10 min) and the message says "may be", not "is".
    STALL_AFTER_S = 600

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.results: List[Dict[str, Any]] = []  # session accumulator
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, names: List[str], params: Dict[str, Any],
               benchmark_params: Optional[Dict[str, Dict[str, Any]]] = None,
               ) -> str:
        unported = [n for n in names if n in UNPORTED_BENCHMARKS]
        if unported:
            raise ValueError(
                f"{unported[0]}: not yet ported; see ROADMAP.md "
                f"{UNPORTED_BENCHMARKS[unported[0]]}")
        apply_params(BenchConfig(), params)  # fail fast on bad params
        for bp in (benchmark_params or {}).values():
            apply_params(BenchConfig(), {**params, **bp})
        job_id = uuid.uuid4().hex[:12]
        with self._lock:
            self.jobs[job_id] = {
                "id": job_id,
                "status": "queued",
                "benchmarks": list(names),
                "params": dict(params),
                "benchmark_params": dict(benchmark_params or {}),
                "completed": 0,
                "total": len(names),
                "current": None,
                "phase": None,
                "phases": [],
                "results": [],
                "errors": [],
                "submitted_at": time.time(),
            }
        self._q.put(job_id)
        return job_id

    def _stalled_seconds(self, job: Dict[str, Any]) -> Optional[int]:
        """Quiet time of a running job past STALL_AFTER_S, else None.
        Caller holds the lock."""
        if job["status"] != "running":
            return None
        quiet = time.time() - job.get("phase_at", job["submitted_at"])
        return int(quiet) if quiet > self.STALL_AFTER_S else None

    def get(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return None
            out = json.loads(json.dumps(job))
            stalled = self._stalled_seconds(job)
            if stalled is not None:
                out["stalled_seconds"] = stalled
            return out

    def list_jobs(self) -> List[Dict[str, Any]]:
        with self._lock:
            rows = []
            for j in self.jobs.values():
                row = {k: j[k] for k in ("id", "status", "benchmarks",
                                         "completed", "total",
                                         "submitted_at")}
                stalled = self._stalled_seconds(j)
                if stalled is not None:
                    row["stalled_seconds"] = stalled
                rows.append(row)
            return rows

    def shutdown(self) -> None:
        self._q.put(None)

    # -- worker ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            job_id = self._q.get()
            if job_id is None:
                return
            self._run_job(job_id)

    def _run_job(self, job_id: str) -> None:
        with self._lock:
            job = self.jobs[job_id]
            job["status"] = "running"
            names = list(job["benchmarks"])
            params = dict(job["params"])
            per_bench = dict(job.get("benchmark_params") or {})

        from gpuaudiobench_tpu_torch.cli import mesh_ranks, rank_json

        def set_phase(p: str) -> None:
            # Stage-boundary progress (runner progress_cb): a long tier
            # reads as its phase, not a hang; ``phases`` keeps them all.
            with self._lock:
                job["phase"] = p
                job["phase_at"] = time.time()
                job["phases"].append(f"{job['current']}:{p}")

        for name in names:
            with self._lock:
                job["current"] = name
            set_phase("setup")

            # One failing benchmark doesn't kill the suite
            # (main.swift:261-341; cli.py run loop).
            try:
                # Per-benchmark form overrides layer over the globals
                # (suite runs would otherwise silently drop them).
                cfg = apply_params(
                    BenchConfig(), {**params, **per_bench.get(name, {})}
                )
                ranks = mesh_ranks(cfg, [name], self.device.type)
                if ranks > 1:
                    payload = self._mesh_job(ranks, name, cfg, set_phase)
                else:
                    payload = rank_json(name, cfg, self.device.type,
                                        progress_cb=set_phase)
                with self._lock:
                    job["results"].append(payload)
                    self.results.append(payload)
                    del self.results[: max(0, len(self.results)
                                           - self.MAX_RESULTS)]
            except Exception as e:  # noqa: BLE001 - suite resilience
                with self._lock:
                    job["errors"].append(f"{name}: {e}")
            finally:
                with self._lock:
                    job["completed"] += 1
        with self._lock:
            job["current"] = None
            job["phase"] = None
            job["status"] = "done"
            job["finished_at"] = time.time()
            done = [jid for jid, j in self.jobs.items()
                    if j["status"] in ("done", "error")]
            for jid in done[: max(0, len(done) - self.MAX_JOBS)]:
                del self.jobs[jid]

    def _mesh_job(self, ranks: int, name: str, cfg: BenchConfig,
                  set_phase) -> Dict[str, Any]:
        """``name`` over ``ranks`` spawned ranks, as the CLI runs it: a
        helper thread waits in ``spmd`` while this (the job) thread
        records each phase rank 0 puts on the queue, until the helper
        puts None after the ranks have ended. Returns rank 0's record or
        raises what ``spmd`` raised."""
        from gpuaudiobench_tpu_torch.cli import (
            SPMD_TIMEOUT_S,
            RankZeroPhases,
            rank_json,
        )
        from gpuaudiobench_tpu_torch.parallel.launch import spmd

        phases = torch.multiprocessing.get_context("spawn").Queue()
        dev = self.device.type
        outcome: Dict[str, Any] = {}

        def wait_for_ranks() -> None:
            try:
                outcome["payload"] = spmd(
                    rank_json, ranks, dev, name, cfg, dev,
                    RankZeroPhases(phases), timeout_s=SPMD_TIMEOUT_S)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                outcome["error"] = e
            finally:
                phases.put(None)

        waiter = threading.Thread(target=wait_for_ranks, daemon=True)
        waiter.start()
        for phase in iter(phases.get, None):
            set_phase(phase)
        waiter.join()
        phases.close()
        if "error" in outcome:
            raise outcome["error"]
        return outcome["payload"]


class PresetStore:
    """Server-side parameter presets (the localStorage analog,
    webgpu/js/app.js:831-872 save/load/reset)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()

    def load(self) -> Dict[str, Any]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def save(self, benchmark: str, preset_name: str,
             params: Dict[str, Any]) -> None:
        with self._lock:
            data = self.load()
            data.setdefault(benchmark, {})[preset_name] = params
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=2)
            os.replace(tmp, self.path)

    def delete(self, benchmark: str, preset_name: str) -> bool:
        with self._lock:
            data = self.load()
            if preset_name in data.get(benchmark, {}):
                del data[benchmark][preset_name]
                if not data[benchmark]:
                    del data[benchmark]
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(data, f, indent=2)
                os.replace(tmp, self.path)
                return True
            return False


def _results_csv(results: List[Dict[str, Any]]) -> str:
    """Session export in the harness's CUDA CSV schema plus the
    saturated/context extension columns -- delegates to the canonical
    JSON->CSV derivation (harness/output.py csv_from_json_results) so
    UI exports and CLI --outputfile CSVs never drift from each other."""
    from gpuaudiobench_tpu_torch.harness.output import csv_from_json_results

    return csv_from_json_results(results)


def make_handler(runner: JobRunner, presets: PresetStore,
                 hardware: Dict[str, Any]):
    class Handler(BaseHTTPRequestHandler):
        server_version = "tpuaudiobench-torch-ui/2"

        # -- plumbing -----------------------------------------------------
        def log_message(self, fmt: str, *args: Any) -> None:  # quiet tests
            if os.environ.get("TPUAB_UI_VERBOSE"):
                super().log_message(fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj: Any, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode(),
                       "application/json; charset=utf-8")

        def _error(self, code: int, msg: str) -> None:
            self._json({"error": msg}, code)

        def _body(self) -> Dict[str, Any]:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw or b"{}")

        def _post_rejection(self) -> Optional[tuple]:
            """Cross-origin / rebinding guard for state-changing routes.

            Browsers can fire no-preflight cross-origin POSTs only with
            simple content types (text/plain, form encodings), so
            requiring application/json forces a CORS preflight -- which
            this server never grants. Checking Host against loopback /
            the bound address blocks DNS-rebinding, where an attacker
            domain resolves to 127.0.0.1 and the browser sends its
            hostname in Host. Returns (code, message) to reject, None
            to allow."""
            ctype = (self.headers.get("Content-Type") or "")
            ctype = ctype.split(";")[0].strip().lower()
            if ctype != "application/json":
                return (415, "Content-Type must be application/json")
            # Host check only makes sense for a loopback bind (where
            # rebinding is the sole route in): a remote client of an
            # explicit 0.0.0.0 bind legitimately sends the machine's
            # IP in Host, which the server cannot enumerate -- the
            # operator accepted exposure at bind time (serve() warns).
            bound = self.server.server_address[0]
            if bound not in ("127.0.0.1", "::1"):
                return None
            host = (self.headers.get("Host") or "").strip()
            if host.startswith("["):  # [::1]:port
                hostname = host.split("]")[0].lstrip("[")
            else:
                hostname = host.rsplit(":", 1)[0] if ":" in host else host
            if hostname.lower() not in {"localhost", "127.0.0.1", "::1",
                                        bound}:
                return (403, f"Host {hostname!r} not served here")
            return None

        # -- routes -------------------------------------------------------
        def do_GET(self) -> None:  # noqa: N802 - http.server API
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            if route == "/" or route == "/index.html":
                try:
                    with open(os.path.join(STATIC_DIR, "index.html"),
                              "rb") as f:
                        self._send(200, f.read(), "text/html; charset=utf-8")
                except OSError:
                    self._error(500, "index.html missing")
            elif route == "/api/hardware":
                self._json(hardware)
            elif route == "/api/benchmarks":
                names = ported_benchmarks()
                self._json(
                    {
                        "benchmarks": [
                            {
                                "name": n,
                                "description":
                                    BENCHMARK_DESCRIPTIONS.get(n, ""),
                                "params": benchmark_params(n),
                            }
                            for n in names
                        ],
                        "categories": {
                            c: members for c, members in CATEGORIES.items()
                            if not any(m in UNPORTED_BENCHMARKS
                                       for m in members)},
                        "global_params": global_params(),
                    }
                )
            elif route == "/api/job":
                q = parse_qs(url.query)
                job = runner.get((q.get("id") or [""])[0])
                if job is None:
                    self._error(404, "unknown job")
                else:
                    self._json(job)
            elif route == "/api/jobs":
                self._json({"jobs": runner.list_jobs()})
            elif route == "/api/presets":
                self._json(presets.load())
            elif route == "/api/compare":
                self._json(published_baselines())
            elif route == "/api/export.json":
                self._json({"results": runner.results})
            elif route == "/api/export.csv":
                self._send(200, _results_csv(runner.results).encode(),
                           "text/csv; charset=utf-8")
            else:
                self._error(404, "not found")

        def do_POST(self) -> None:  # noqa: N802 - http.server API
            url = urlparse(self.path)
            route = url.path.rstrip("/")
            rej = self._post_rejection()
            if rej is not None:
                self._error(*rej)
                return
            try:
                body = self._body()
            except json.JSONDecodeError:
                self._error(400, "invalid JSON body")
                return
            if route == "/api/run":
                names = body.get("benchmarks") or []
                category = body.get("category")
                if category:
                    if category not in CATEGORIES:
                        self._error(400, f"unknown category: {category}")
                        return
                    names = list(CATEGORIES[category])
                unknown = [n for n in names if n not in list_benchmarks()]
                if unknown:
                    self._error(400, f"unknown benchmarks: {unknown}")
                    return
                if not names:
                    self._error(400, "no benchmarks given")
                    return
                try:
                    job_id = runner.submit(
                        names, body.get("params") or {},
                        body.get("benchmark_params") or {},
                    )
                except ValueError as e:
                    self._error(400, str(e))
                    return
                self._json({"job_id": job_id}, 202)
            elif route == "/api/presets":
                action = body.get("action", "save")
                bench = body.get("benchmark")
                pname = body.get("name")
                if not bench or not pname:
                    self._error(400, "benchmark and name required")
                    return
                if action == "save":
                    presets.save(bench, pname, body.get("params") or {})
                    self._json({"ok": True})
                elif action == "delete":
                    self._json({"ok": presets.delete(bench, pname)})
                else:
                    self._error(400, f"unknown action: {action}")
            else:
                self._error(404, "not found")

    return Handler


def serve(
    port: int = 8800,
    host: str = "127.0.0.1",
    presets_path: str = DEFAULT_PRESETS_PATH,
    device: str = "cuda",
) -> ThreadingHTTPServer:
    """Build (but do not start) the server; caller runs serve_forever().
    Port 0 binds an ephemeral port (tests). Jobs run on the card unless
    ``device`` is "cpu"; with no card, "cuda" raises."""
    from gpuaudiobench_tpu_torch.utils import device as dv

    torch_dev = dv.device(device)
    hardware = hardware_info(torch_dev)
    runner = JobRunner(torch_dev)
    presets = PresetStore(presets_path)
    if host not in ("127.0.0.1", "localhost", "::1"):
        import sys

        print(
            f"WARNING: binding {host} exposes an unauthenticated device-"
            "job API beyond loopback; prefer an SSH tunnel to 127.0.0.1",
            file=sys.stderr,
        )
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(runner, presets, hardware))
    httpd.job_runner = runner  # type: ignore[attr-defined]
    return httpd


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m gpuaudiobench_tpu_torch.webui",
        description="Interactive GPU audio benchmark runner (PyTorch port)",
    )
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--presets", default=DEFAULT_PRESETS_PATH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    httpd = serve(args.port, args.host, args.presets, args.device)
    addr = httpd.server_address
    print(f"GPU Audio Benchmark UI: http://{addr[0]}:{addr[1]}/",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.job_runner.shutdown()  # type: ignore[attr-defined]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
